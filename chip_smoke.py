#!/usr/bin/env python3
r"""Runs the PyTorch port's serving and training paths on one NVIDIA H100 and checks them.

    python3 chip_smoke.py        # from the repository root, on a machine with one CUDA card

Needs PyTorch built for CUDA, Triton and ``nvcc``; never imports JAX. It
builds the port's kernels from ``vp_suite_tpu_torch/csrc`` and then:

1. prints the card (``nvidia-smi`` name and power limit) and the versions,
   and checks that ``-Xptxas -v`` reports no spilled bytes for any
   instantiation of the scan kernels (``csrc/convlstm_scan{,_bwd}.cu``), of
   K8's bf16 kernels (``csrc/warp_ret.cu``) and of K9's bf16 forward and
   general d_A / d_Bm kernel (``csrc/warp_contract.cu``);
2. holds K1, the ConvLSTM gate kernel, and K2, its backward (both Triton),
   against ``convlstm_gate_reference`` and ``convlstm_gate_backward_reference``
   at EF-ConvLSTM's three cell shapes, b=32;
3. holds K3, the whole-recurrence ConvLSTM scan kernel, and K3s, its form
   that saves the training residuals (CUDA C++), against
   ``convlstm_scan_forward_reference`` at the same shapes, in decode mode
   (T=10) and with a precomputed input half (T=5), in f32 and bf16 (the
   bf16 kernel: resident weights, a ``cp.async`` ring of h stages, ``wgmma``);
   K3s must leave ``h_seq`` and ``c_last`` bit for bit as K3 gives them;
4. holds K4, the scan's reverse-time backward (CUDA C++), against
   ``convlstm_scan_backward_reference`` at the fused training path's six
   launch shapes with a nonzero gradient of ``h_last``, and the scan's eight
   input gradients through its autograd Function, of a loss over ``h_seq``,
   ``h_last`` and ``c_last``, against autograd of the plain forward;
5. holds the multi-flow bilinear warp's forward and backward kernels (CUDA
   C++) against ``warp_sample_reference`` and
   ``warp_sample_backward_reference`` at EF-TrajGRU's three layer shapes
   (b=32, L=13), in f32 and bf16, on flows of a few pixels, some of which
   leave the image, and the warp's three gradients through its autograd
   Function against autograd of the plain forward; prints both kernels'
   tilings and the share of the in-image taps that leave their block's band
   at each shape (read from global memory in the forward, sent to global
   atomics in the backward);
6. holds K8, the warp fused with TrajGRU's 1x1 ``ret`` conv (``warp_ret``;
   CUDA C++ forward and backward; in bf16 wgmma kernels on the image's band of
   rows, whose plan it prints beside its Python mirror), against ``warp_ret_reference`` and
   ``warp_ret_backward_reference`` at the same three shapes (O = 3f) in f32
   and bf16, its five gradients through ``WarpRetFunction`` against autograd
   of the plain forward, and ``warp_ret`` against ``warp_flow_ret`` (the warp
   kernel and a cuBLAS GEMM, the unfused path TrajGRU runs) for the output
   and the five gradients, on the same image, flows, weights and bias;
7. holds K9, the warp by prebuilt factor matrices (``warp_contract``; CUDA
   C++ forward and backward), against ``warp_contract_reference`` and
   ``warp_contract_backward_reference`` on dense random factors at the same
   three shapes in f32 and bf16, its three gradients through
   ``WarpContractFunction`` against autograd of the plain forward, and
   ``warp_contract`` on one-hot factors (``_onehot_factor``) against
   ``warp_sample`` in f32; and in bf16 at two shapes beyond the layer shapes,
   w = 200 (d_A / d_Bm in column chunks) and h = 512 (the forward's A tile
   in parts);
8. drives K8's and K9's path, ``warp_ret`` and ``warp_contract`` with their
   gradients once at each shape in bf16, with the launch counts set to 0 just
   before and held exactly just after (three calls of each: 3 launches of
   each forward, 9 of K8's backward and 6 of K9's; nothing else);
9. drives the serving path: ``VPSuite()`` -> ``create_model`` at 64x64 RGB
   in bf16 -> ``predict(32 x 5 frames, pred_frames=10)`` for EF-ConvLSTM
   per-step (K1) and with ``use_fused_scan`` (K3), and for EF-TrajGRU
   (``"trajgru"``: the warp forward), with the kernels' launch counts set to 0
   just before each and read just after (K8 and K9 at 0: no model reaches
   them, as in the JAX package); checks the predictions, and at b=2 holds
   them against the same weights run on the CPU in f32;
10. drives the training path: ``create_train_state`` and ``make_train_step``
    (Adam, lr 1e-4, MSE) on the same models' configurations, b=32, 5 -> 10,
    bf16: EF-ConvLSTM per-step (K1 45 and, under the cells' default
    ``remat_policy="gates"``, 45 again in the backward, + K2 45) and fused
    (K3s + K4), EF-TrajGRU (the warp forward and backward), with the counts set to 0 just before the first
    step and read just after; checks losses, gradients and launch counts,
    prints the share of the warp backward's taps outside their block's band
    for the indices of EF-TrajGRU's second step, and at b=2 holds one f32 SGD
    step on the card against the same step on the CPU;
11. drives the facade's training path: ``VPSuite()`` ->
    ``load_dataset("MMF", digit_source="synthetic", img_size=64, ...)`` ->
    ``create_model`` in bf16 (img_shape and the rest from the dataset) ->
    ``train`` (b=32, 5 -> 10): EF-ConvLSTM per-step for 2 epochs of 8 steps
    and fused for 1 epoch of 4 steps on batches made on the card
    (``backend="device"``), and per-step for 1 epoch of 3 steps on the numpy
    host backend, each with the launch counts set to 0 just before ``train``
    and held exactly just after (every train step's and every validation
    forward's); prints each epoch's frames/s, checks the losses, that
    ``load_model`` restores the trained parameters and predicts the same
    frames, that a host batch through ``device_prefetch`` is the loader's, and
    the card's batch generator (speeds, start positions, values, one seed one
    stream), and prints the device's busy share of one more device-backend
    epoch under the profiler;
12. drives the facade's test path, each path in a suite of its own:
    ``VPSuite()`` -> ``load_model`` (the best checkpoint of step 11's
    device-backend runs, per-step and fused) -> ``load_dataset("MMF",
    split="test", img_size=64, digit_source="synthetic")`` ->
    ``test(brief_test=True, 5 -> 10, metrics="all")`` with PyTorch's default
    TF32 flags (cuDNN's on: the measures must turn it off themselves), with
    the launch counts set to 0 just before ``test`` and held exactly just
    after (each of the 10 test batches' K1 or K3; CopyLastFrame launches
    none); checks every horizon's measures (FVD from 9 frames on), the
    CopyLastFrame rows against a recomputation from the same batches, and
    every measure on the card against the CPU on one (pred, target) pair of
    the run; prints each ``test`` call's wall time and the device time of
    LPIPS, FVD (I3D) and SSIM on one batch under the profiler;
13. drives the file-backed data layer: writes a KTH tree at KTH's shape (6
    classes x 22 persons, 40 64x64 frames each; grey and RGB PNGs whose rows
    cycle through all five PNG filters), a BAIR tree (272 sequences of 30
    64x64 frames and 4-d actions) and a KITTI raw tree (3 drives of 30
    375x1242 PNGs) under ``vp-suite-data/chip_smoke/``; reads a sample of the
    PNGs back bit for bit; ``load_dataset("KTH")`` -> ``create_model`` (bf16)
    -> ``train`` (b=32, 5 -> 10, 2 epochs) with ``hbm_cache="on"`` (the
    training and validation sets staged in the card's memory) and again with
    ``"off"`` (the host loader), K1/K2 counts held exactly, frames/s of each;
    one epoch of cached batches against the host loader's on the card; the
    same on BAIR on the fused path (K3s/K4), then a brief ``test`` of its
    checkpoint (K3 for each of 10 batches); KITTI items at 128x160 (ms per
    item); and one epoch of on-the-fly Moving MNIST's native backend (the C
    generator; an item the same read twice and from two threads) beside the
    numpy and device backends; then deletes what it wrote;
14. times each kernel at the shapes its path gives it, beside its plain
    version, its bound and the one PyTorch call that computes the same
    function (``F.grid_sample`` for the warp, ``torch.einsum`` for K9's
    forward; for K8, whose fused function no one call computes,
    ``warp_flow_ret`` itself, forward and backward through autograd, on the
    same inputs; beside K9's backward call, as a comparison,
    ``torch.autograd.grad`` through ``torch.einsum``), and times
    ``predict`` and the train step, with the warp forward's device time in
    EF-TrajGRU's ``predict`` and the warp forward's and backward's in its
    train step under the profiler.

15. drives UNet-3D (``create_model("unet-3d", temporal_dim=3)``, features
    8/16/32/64), PredRNN++ (``"predrnn-pp"``: 3 ST-LSTM layers of 128,
    4x4 patches, 5x5 filters, ``reverse_input``, so a train step runs 2b=64),
    PhyDNet (``"phy"``), MinConvRNN (``"min-conv-rnn"``), SimVP (``"simvp"``,
    ``in_frames=5``), PredFormer (``"pred-former"``), ST-Phy (``"st-phy"``)
    and the encoder-LSTM-decoder (``"lstm"``)
    at b=32, 64x64, 5 -> 10, bf16, under PyTorch's default TF32 flags (a
    user's): ``predict`` and the Adam train step with every kernel's launch
    count set to 0 just before and held at 0 just after (no such model
    reaches a port kernel), their compiled latencies (median of 3 predicts
    after the capture, of 4 replays after the eager call and the capture)
    and one profiled replay of each, the peak memory of one eager step; the
    loss falls at each of 7 steps (an eager one, then the compiled step's)
    and PredRNN++'s schedule is exactly the one 7 steps leave; at b=2
    in f32 (TF32 off), ``predict`` and one SGD step on the card against the
    CPU, with UNet-3D's running statistics and PredRNN++'s schedule (PhyDNet's
    step with f64 activations on both sides; PhyDNet's and ST-Phy's f32
    steps' distances from each other and from f64), and the bf16 ``predict``
    of PhyDNet and the last five against the CPU's f32; ST-Phy's and LSTM's
    action-conditional f32 ``predict`` (3 action channels) on the card
    against the CPU; then
    one facade run per model
    (``load_dataset("MMF")`` -> ``create_model`` -> ``train`` of 2 steps on
    the card's batches -> ``load_model``, whose ``predict`` must equal the
    trained entry's);
16. drives the facade's tooling (``drive_tooling``), every kernel count set to
    0 just before each part and held exactly just after: ``train`` (1 epoch of
    3 steps, ``vis_every=1``, ``n_vis=2``) and a brief ``test`` with
    ``vis_compare`` on the per-step and fused paths, the visualisations'
    predictions counted (each PNG read back bit for bit by ``read_png``, each
    GIF's header, 15 frames, NETSCAPE2.0 loop and delays checked);
    ``hyperopt`` of 3 trials of 2 steps on the fused path (``lr`` on a log
    scale and the loss mix; K3s and K4 6 a step) with its ``best_params``;
    ``train`` with ``profile_dir`` (epoch 2's Chrome trace names K1's and K2's
    kernels); ``count_flops`` of ``predict`` and the train step, equal on the
    card and the CPU for every registry model at a small size, and at bench
    shapes for paths (a)-(c) and the eight other models with TFLOP per call and
    the share of 989 TFLOP/s at the latencies measured above; the
    batch-polymorphic ``torch.export`` programs of the three paths (run at b=8
    and 32), whose graphs call the kernels' operators
    and whose every call launches K1 45, K3 6 or the warp forward 45 times,
    within the bf16 gate of ``predict`` and timed beside it; and a
    reference-named stand-in module and its ``state_dict`` through
    ``load_torch_model`` and ``model_from_import``, whose ``predict`` is
    bit-equal to the source model's;
17. drives data-parallel training (``drive_parallel``) in child processes
    started with torchrun's variables on a free loopback port, each with its
    own time limit: (i) a world of one process over NCCL through the facade
    (``initialize_multihost()`` -> ``VPSuite()`` -> ``load_dataset("MMF")``
    -> ``train(multihost=True)``, b=32, 5 -> 10, bf16, two epochs of 3
    steps, compiled as without a group): the fused path with ``fsdp=True``
    and the sharded (``"orbax"``) checkpoint, the per-step path replicated,
    each with its launch counts held exactly (those of the first two calls of
    each step), its second epoch's frames/s beside the same run's without a
    group; f32 runs at b=8 under cuDNN's deterministic algorithms, whose
    parameters must equal the same runs' without a group within 1e-6
    relative; and (iii) in the same world, the three step builders with
    ``mesh=make_mesh(0, "data", "cuda")`` and ``use_jit=True`` on (a), on (b)
    under FSDP2 with ``accum_steps`` 1 and 2, and on (c), each against
    ``use_jit=False`` on the same mesh in f32 at b=2: bit-identical on (a) and
    (b), within the SGD gate on (c), the launches of the eager call and of the
    capture and none from the host in a replay, replays under
    ``set_sync_debug_mode("error")``, the collectives called while capturing,
    the profiler's kernels of a replay, the order of NCCL's nodes in the
    graph's debug dump, and the bf16 b=32 step graphed on the mesh beside the
    graphed step without one; (ii) two
    processes on the one card over gloo: one f32 SGD step of each path on
    each process's half of a b=8 batch (the fused path under FSDP), against
    the one-process step on the whole batch in this process ((p0 - p1) / lr
    within the smoke's SGD gate; FSDP's parameters from both processes' rows),
    the processes' replicated parameters equal, and the
    sharded checkpoint they wrote loaded here without a group through
    ``VPSuite.load_model``, whose ``predict`` launches K3 and equals the
    prediction of the processes' parameters;
18. drives tensor parallelism (``drive_tensor_parallel``) in child processes
    the same way: (t1) a world of one over NCCL
    on ``make_mesh_nd({"data": 1, "sp": 1, "tp": 1})``: each EF-ConvLSTM
    path's f32 SGD step at b=8 (full width, 64x64, 5 -> 10) and ``predict``,
    compiled on the mesh (3 calls: eager, capture, replay), with exact launch
    counts, the steps' parameters bit-identical to the steps' without a
    group; (t2) two processes on the one card over gloo on
    ``{"data": 1, "tp": 2}`` under ``shard_params_tp``: each process holds
    exactly its slice of every sharded leaf, ``predict`` (K1 45 or K3 6 a
    process) within 1e-4 of one process's, the SGD step (K1 90 + K2 45 or
    K3s 6 + K4 6 a process) within the SGD gate of the one-process step, its
    time beside the one-process step's and its tp collectives' time (CUDA
    events around each alone, summed; two processes on one card measure no
    scaling); (t3) four processes on a 2x1x2 data x sp x tp mesh under
    ``shard_params_tp_fsdp``: the fused path's SGD step within the same gate;
19. drives spatial, context and pipeline parallelism
    (``drive_model_parallel``) in one world of two gloo processes on the one
    card: (s) each EF-ConvLSTM path at full width on ``{"data": 1, "sp": 2}``
    (each process 32 of the 64 image rows, its convolutions exchanging halo
    rows): ``predict`` (whole frames) within 1e-4 of one process's, the f32
    SGD step at b=8 within the SGD gate of the one-process step, K1 45 (90
    and K2 45 in the step) or K3 6 (K3s 6 + K4 6) a process, the step's spatial collectives
    counted, sized and timed alone; (q) MinConvRNN at its defaults, 6 -> 10,
    with its context scan over ``{"seq": 2}``, ``predict`` and an SGD step
    against one process; (p) ``gpipe_apply`` of a 3x3 conv + tanh stage over
    ``{"pp": 2}``, output and gradients against the serial stages;
20. drives the compiled step (``drive_graphs``, after step 15; the builders'
    ``use_jit=True``, CUDA-graph capture): for ``predict`` and the Adam train
    step of EF-ConvLSTM per-step and fused and EF-TrajGRU at b=32 bf16, the
    launch counts of the eager first call and of the capture (as one call
    launches) and none from the host in a replay, the profiler's kernel
    counts over one replay, the host time of the eager call, the capture and
    a replay, and eager against graphed latency, device time and busy share
    (step 15 prints the same for the other eight models); at b=2 f32 under
    cuDNN's deterministic algorithms the graphed SGD and Adam steps and
    ``predict`` against the eager ones (a ReduceLROnPlateau cut after the
    capture), and PhyDNet's teacher-forcing coins and PredRNN++'s sampling
    masks, graphed against eager, across the epoch and iteration where they
    change;
21. drives rematerialisation (``drive_remat``, after step 20; ``remat``,
    ``vp_suite_tpu_torch.nn.remat``) on and off for the Adam train step at
    b=32 bf16 on EF-ConvLSTM per-step under the cells' ``"gates"`` and
    ``"full"`` policies, fused, EF-TrajGRU and the other eight models: the
    peak card memory of one eager step above what was live, the launches of
    the eager call and of the capture (K1 45 + 45 on the per-step path with
    remat on, 45 off; K2, K3s / K4 and the warp as before; none on the other
    models), the graphed step's latency; ``predict``'s launches on the three
    kernel paths, equal with remat on and off; and in f32 at b=2 the SGD step
    with remat on against off (bit-identical; EF-TrajGRU within the SGD gate)
    and the graphed step under ``"full"`` against the eager one;
22. drives FVD as a loss inside the compiled steps (``drive_fvd_loss``, after
    step 21): E1, the Jacobi eigensolver (``csrc/sym_eig.cu``), against
    ``torch.linalg.eigh`` in f64 (the card's f32 one printed beside) at b = 1,
    2, 4, 10, 32, 128, 160 and 256 on FVD-made matrices, on repeated
    eigenvalues and on a batch of three, twice bit-identical; its time at b=32
    beside its bound and ``torch.linalg.eigh``'s; ``wasserstein2_torch`` on the
    card against the CPU, value and gradient; the Adam train step of paths (a)
    and (b) at b=32 bf16 with ``{"mse", "fvd"}``, eager and graphed (E1 once a
    call beside K1 45 + 45 and K2 45, or K3s 6 and K4 6; replays under
    ``torch.cuda.set_sync_debug_mode("error")``); an f32 SGD step at b=4 on the
    card against the CPU and graphed against eager; and ``VPSuite.train`` of
    (a) with ``val_rec_criterion="fvd"`` (1 epoch of 3 compiled steps).

Step 1 also prints which video decoders the machine offers (the ``ffmpeg``
binary, the ``avcodec`` library, ``torchvision``, ``torchcodec``).

Since the compiled step is the builders' default, the facade's runs in steps
11-13 and 16 count the launches of the first two calls of each step (the
eager call and the capture), in a group over NCCL too; step 10's timed train
steps and the phases over gloo build with ``use_jit=False`` (gloo's
collectives run on the host, which a graph cannot hold), and step 14 times
the facade's compiled ``predict`` beside step 10's eager train step.

Any failed check exits non-zero before the result lines. The last two lines
of standard output are the kernels' JSON line and the result JSON line.
"""
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# One H100 SXM (NVIDIA's data sheet, dense rates at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
#: f32 operations per element of the gate block: three sigmoids and two tanhs
#: (each counted as 4) plus the peephole products, the cell update and h.
GATE_OPS_PER_ELEMENT = 30
#: and of its backward: the recomputed forward plus some 25 products and sums.
GATE_BWD_OPS_PER_ELEMENT = 55

B = 32                      # serving and training batch
CTX, PRED = 5, 10           # context and predicted frames
IMG = (3, 64, 64)           # (c, h, w)
SEED = 0
LR = 1e-4                   # Adam's learning rate (the run default)
#: (side, channels) of EF-ConvLSTM's recurrent cells at 64x64, and of EF-TrajGRU's.
CELLS = ((64, 64), (32, 96), (16, 96))
TRAJ_L = 13                 # EF-TrajGRU's flows per layer
#: the paths driven: name -> (registry id, model configuration).
PATHS = {
    "per_step": ("convlstm-shi", {}),
    "fused_scan": ("convlstm-shi", dict(use_fused_scan=True, interleaved_encode=False,
                                        interleaved_forecast=False)),
    "trajgru": ("trajgru", {}),
}
KERNEL_IDS = ("K1", "K2", "K3", "K3s", "K4", "warp_fwd", "warp_bwd", "warp_ret_fwd", "warp_ret_bwd",
              "warp_contract_fwd", "warp_contract_bwd", "E1")


def _launches(**counts):
    return {k: counts.get(k, 0) for k in KERNEL_IDS}


#: launches per predict on each path (3 layers, 5 -> 10: 15 cell steps per
#: layer); the fused path's K3 count is also held against the model's scans.
WANT_PREDICT_LAUNCHES = {"per_step": _launches(K1=45), "fused_scan": _launches(K3=6),
                         "trajgru": _launches(warp_fwd=45)}
#: launches per train step on each path, with each model's default ``remat``: the
#: per-step cells' ``"gates"`` policy keeps each step's gate pre-activations and
#: launches K1 again in the backward (45 + 45); the fused path and EF-TrajGRU's
#: policy (which keeps the warp tensor) launch no kernel again.
WANT_TRAIN_LAUNCHES = {"per_step": _launches(K1=90, K2=45),
                       "fused_scan": _launches(K3s=6, K4=6),
                       "trajgru": _launches(warp_fwd=45, warp_bwd=45)}
#: and with ``remat`` off (the cells' ``remat=False``)
WANT_TRAIN_LAUNCHES_NO_REMAT = {**WANT_TRAIN_LAUNCHES, "per_step": _launches(K1=45, K2=45)}
#: the facade's runs: ``load_dataset("MMF", ...)`` -> ``create_model`` ->
#: ``train``, as (path, dataset backend, epochs, steps per epoch); each epoch
#: validates on one batch of B sequences, which the host loader makes.
SUITE_RUNS = (("per_step", "device", 2, 8), ("fused_scan", "device", 1, 4),
              ("per_step", "numpy", 1, 3))


def compiled_calls(calls):
    r"""The calls of a compiled step (``use_jit=True``, one batch shape) that
    launch kernels from the host: the first (eager) and the second (the
    capture); the replays after them launch none from the host."""
    return min(calls, 2)


def want_suite_launches(path, epochs, steps, val_batches=1, compiled=True):
    r"""Launches of a ``train`` run: each train step's and each validation
    forward's, as one predict or train step launches them; with ``compiled``
    steps (the facade on one card without a group) those of the first two
    calls of each (:func:`compiled_calls`)."""
    train, val = WANT_TRAIN_LAUNCHES[path], WANT_PREDICT_LAUNCHES[path]
    n_train, n_val = epochs * steps, epochs * val_batches
    if compiled:
        n_train, n_val = compiled_calls(n_train), compiled_calls(n_val)
    return {k: n_train * train[k] + n_val * val[k] for k in KERNEL_IDS}


#: the facade's test path: a brief test (the first 10 of the test set's
#: sequences, one a batch) of each path's trained checkpoint, and CopyLastFrame;
#: its predictor is compiled, so the first two batches launch.
TEST_SEQS = 16
TEST_BATCHES = 10
WANT_TEST_LAUNCHES = {path: {k: compiled_calls(TEST_BATCHES) * v
                             for k, v in WANT_PREDICT_LAUNCHES[path].items()}
                      for path in ("per_step", "fused_scan")}

#: no model reaches K8 or K9 (the JAX package's TrajGRU runs warp_flow_ret); their
#: path is their entry points, ``warp_ret`` and ``warp_contract`` with their
#: gradients, run once at each of EF-TrajGRU's three layer shapes in bf16. Each
#: backward call is several launches: K8's three, K9's two.
WANT_ENTRY_LAUNCHES = _launches(warp_ret_fwd=len(CELLS), warp_ret_bwd=3 * len(CELLS),
                                warp_contract_fwd=len(CELLS), warp_contract_bwd=2 * len(CELLS))

# Tolerances, with their reasons.
#: K1/K2 f32: the same f32 formula; exp/tanh differ between Triton and PyTorch by ulps.
GATE_ATOL_F32 = 1e-5
#: K1/K2 bf16: both compute in f32 and round once, so the two f32 results, which
#: differ by up to GATE_ATOL_F32 (cancellation in f*c + i*tanh(gc) leaves
#: values near 0 with that much absolute error), each round to bf16: 2 bf16
#: ulps of the value plus GATE_ATOL_F32.
GATE_BF16_ULPS = 2
#: K3/K3s f32 (TF32 off): the same products summed in another order over K=9*enc.
SCAN_ATOL_F32 = 1e-4
#: K3/K3s bf16: h is rounded to bf16 every step, and a sum taken in another order
#: flips some roundings by one ulp; those flips feed the next steps.
SCAN_ATOL_BF16 = 3e-2
#: K4 and the scan's gradients, f32: sums in another order (the transposed conv
#: over K=9*4enc, cuDNN's weight gradient over T*b*sh*sw), relative to the
#: largest gradient of each kind (max|want|).
GRAD_REL_F32 = 1e-4
#: the hidden kernel's gradient, f32: cuDNN's weight gradient sums T*b*sh*sw
#: (up to 1.3M) products per weight, in one batched call on the kernel path and
#: per step on the plain one; f32 rounding grows like sqrt(N)*2^-24 of the
#: terms' scale, and cancellation makes it larger relative to the result.
GRAD_REL_F32_WEIGHT = 1e-3
#: K4 bf16, relative to the largest gradient of each kind: both sides round dz
#: to bf16 every step; an f32 sum in another order flips some of those
#: roundings by one ulp (2^-8 of the value, 3.9e-3 at the largest), and the
#: flips feed the earlier steps through the transposed conv. Measured on an
#: H100 at the six launch shapes: dz up to 3.8e-3, dh0 1.6e-3, dc0 3.1e-4. A
#: K4 whose bf16 path reads unflipped x-taps gives 0.33 or more, one whose dc
#: carry drops its dzf*wcf term 1.7e-2 (dz) and 5.4e-2 (dc0).
GRAD_REL_BF16 = 1e-2
#: the scan's gradients in bf16 against autograd of the plain forward, which
#: rounds at other places (dh at every step, dz never), relative to the
#: largest: measured up to 7.3e-3 (the faults above give 0.1 or more, and
#: 5.4e-2 at c0).
GRAD_REL_BF16_AUTOGRAD = 2e-2
#: the warp forward, f32: the same f32 formula, products summed in another
#: order (FMA on the card), on values of order 1.
WARP_ATOL_F32 = 1e-5
#: the warp forward, bf16: both sides round an f32 sum of the same four
#: products, which differ by WARP_ATOL_F32 at most: one bf16 ulp of the value.
WARP_BF16_ULPS = 1
#: the warp backward and the warp's gradients through its Function, f32,
#: relative to the largest of each kind: sums over c (d_iy, d_ix) and the
#: f32 atomics (d_img) taken in another order.
WARP_GRAD_REL_F32 = 1e-5
#: bf16: d_img is an f32 sum rounded to bf16 on both sides, so one rounding
#: may flip: one bf16 ulp of the largest (2^-7 of it), plus the f32 limit;
#: d_iy and d_ix stay f32 sums of the same bf16 values.
WARP_GRAD_REL_BF16 = 2 ** -7 + WARP_GRAD_REL_F32
#: K8 (warp_ret) in f32 against its plain versions and through its Function,
#: relative to the largest of each kind: sums of L*f products (the forward,
#: g_l) or of b*P products (d_W) taken in another order, d_img by f32 atomics.
RET_REL_F32 = 1e-5
#: K9 (warp_contract) in f32, relative to the largest: sums of h*w products (the
#: forward, d_A, d_Bm) or of L*P*h*w (d_img) taken in another order.
CONTRACT_REL_F32 = 5e-5
#: K8 and K9 in bf16, relative to the largest of each kind: both sides round
#: each result once (one bf16 ulp of the largest is at most 2^-7 of it), and a
#: sum taken in another order flips some of those roundings, and those of K8's
#: samples and g_l, which both sides round; K9's kernel rounds M = A*Bm to
#: bf16 (as the TPU kernel forms it), where the plain version keeps f32.
FACTOR_REL_BF16 = 2 ** -6
#: warp_ret against warp_flow_ret (the warp kernel and a cuBLAS GEMM), relative
#: to the largest of each kind, in f32: sums taken in another order.
FLOW_RET_REL_F32 = 1e-5
#: in bf16: warp_flow_ret also rounds the bias to bf16 and computes d_w and
#: d_bias in bf16 (each rounded once), where warp_ret keeps them in f32.
FLOW_RET_REL_BF16 = 2 ** -5
#: bf16 warp_contract beyond the layer shapes, (b, L, P, h, w, c): w = 200, whose
#: d_A / d_Bm run in two column chunks of 128 with f32 scratch, and h = 512, whose
#: forward stages its A tile in two parts.
CONTRACT_EXTRA = ((1, 1, 400, 2, 200, 8), (1, 1, 128, 512, 16, 8))
#: the one-hot warp_contract against warp_sample in f32: at most four non-zero
#: products per output, summed in another order, on values of order 1.
ONEHOT_ATOL_F32 = 1e-5
#: predict in f32 on the card (TF32 off) against the CPU in f32: 15 steps of
#: sums taken in another order; the repo's golden tolerance.
PREDICT_ATOL_F32 = 1e-4
#: predict in bf16 against f32, and per-step against fused in bf16: the
#: per-step path rounds the gate pre-activations and the cell to bf16 every
#: step, the fused path keeps both in f32, over 15 steps and 3 layers.
PREDICT_ATOL_BF16 = 5e-2
#: one f32 SGD step on the card against the CPU, as (p0 - p1) / lr: the
#: JAX package's tolerance for gradients through 15 steps and 3 layers.
STEP_TOL = 5e-4
#: the measures' display values on the card against the CPU in f32, relative:
#: the same f32 formulas, sums in another order (SSIM's Gaussian window is made
#: on the host, so both blur with the same weights). LPIPS and FVD sum
#: convolutions of up to 7*7*7*3 taps through 5 and 22 layers: measured on an
#: H100 0 and 2.0e-6 on these predictions, and 1.0e-5 and 2.2e-4 with TF32 let
#: into their convolutions (the phase prints both), which these limits refuse.
MEASURE_RTOL = {"mse": 1e-5, "l1": 1e-5, "smooth_l1": 1e-5, "psnr": 1e-5, "ssim": 1e-5,
                "lpips": 2e-6, "fvd": 2e-5}
#: CopyLastFrame's test results against their recomputation from the same
#: batches: means over the batches in another order (f64 on the host, or the
#: same measures on the same device).
COPY_RTOL = 1e-5


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, iters=10):
    r"""Mean device time of ``fn()`` in ms (CUDA events over ``iters`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=100):
    r"""Mean device time of ``fn()`` in ms, replayed from a CUDA graph of
    ``iters`` calls: the card's time alone, without the host's launch cost."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, warmup=2, iters=5) / iters


def bf16_ulp(x):
    import torch
    x = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def rel_err(got, want):
    r"""Largest absolute error over the largest |want|."""
    return max_err(got, want) / (want.float().abs().max().item() or 1.0)


def gate_cost(side, ch, itemsize, backward=False):
    r"""(bytes, ops) of one gate launch. Forward: gates, c and peepholes read,
    h and c' written (7n). Backward: gates, c, dh, dc' and peepholes read, the
    four gate gradients and dc written (12n)."""
    n = B * side * side * ch
    streams, ops = (12, GATE_BWD_OPS_PER_ELEMENT) if backward else (7, GATE_OPS_PER_ELEMENT)
    return (streams * n + 3 * side * side * ch) * itemsize, ops * n


def scan_cost(side, enc, steps, with_x, itemsize, save_gates=False):
    r"""(bytes, ops) of one forward scan launch: i2h, h0, c0, weights, bias and
    peepholes read, h_seq and c_last written, and with ``save_gates`` z and
    c_prev written; the 3x3 hidden conv's MACs."""
    px = B * side * side
    elems = (steps * px * 4 * enc if with_x else 0) + 2 * px * enc + 36 * enc * enc \
        + 3 * side * side * enc + steps * px * enc + px * enc
    if save_gates:
        elems += steps * px * 5 * enc
    return elems * itemsize + 16 * enc, 2 * steps * px * 9 * enc * 4 * enc


def scan_bwd_cost(side, enc, steps, itemsize):
    r"""(bytes, ops) of one K4 launch: z, c_prev, dh_seq, dh_last, dc_last,
    weights and peepholes read, dz written, dh0 and dc0 written in f32; the
    transposed 3x3 conv's MACs."""
    px = B * side * side
    elems = steps * px * (4 + 1 + 1 + 4) * enc + 2 * px * enc + 36 * enc * enc \
        + 3 * side * side * enc
    return elems * itemsize + 2 * px * enc * 4, 2 * steps * px * 9 * 4 * enc * enc


def warp_cost(side, ch, itemsize, backward=False):
    r"""(bytes, ops) of one warp launch at b=32, L=13, P=side^2. Forward: the
    image and the f32 indices read once, the [b, P, L, c] output written
    once; 4 multiply-adds per output element. Backward: g, the image and the
    indices read once, d_img (in the image's type) and the f32 index
    gradients written once; per element of g 4 products for d_img, 4
    additions into it and 8 operations for d_iy and d_ix."""
    samples = B * side * side * TRAJ_L
    img = B * side * side * ch * itemsize
    if backward:
        return samples * ch * itemsize + 2 * img + 4 * samples * 4, 16 * samples * ch
    return img + 2 * samples * 4 + samples * ch * itemsize, 8 * samples * ch


def warp_ret_cost(side, ch, itemsize, backward=False):
    r"""(bytes, ops) of one K8 call at b=32, L=13, f=ch, O=3ch, P=side^2, with
    the work as the JAX kernels define it. Forward: the image, the f32
    indices, w and the f32 bias read once, the [b, P, O] output written once;
    the contraction's 2*b*P*L*f*O operations and the gather's 8 per sample and
    channel. Backward: g, the image, the indices and w read once, d_img (in
    the image's type), the f32 index gradients and the f32 d_w written once;
    the two contractions the function needs (g_l = g W_l^T and d_W = warp_l^T
    g) and 24 operations per sample and channel for the gathers (the warp
    that d_W needs among them) and the scatter."""
    P, O = side * side, 3 * ch
    samples = B * P * TRAJ_L
    img, w = B * P * ch * itemsize, TRAJ_L * ch * O * itemsize
    mac = 2 * samples * ch * O
    if backward:
        return (B * P * O * itemsize + 2 * img + 4 * samples * 4 + w + TRAJ_L * ch * O * 4,
                2 * mac + 24 * samples * ch)
    return img + 2 * samples * 4 + w + O * 4 + B * P * O * itemsize, mac + 8 * samples * ch


def contract_cost(side, ch, itemsize, backward=False):
    r"""(bytes, ops) of one K9 call at b=32, L=13, an image side x side x ch
    and P = side^2 output pixels. Forward: A [b, L, P, h], Bm [b, L, P, w] and
    the image read once, out [b, L, P, c] written once; 2*b*L*P*h*w*c
    operations. Backward: A, Bm, the image and g read once, d_A, d_Bm and
    d_img written once; twice the forward's operations."""
    P = side * side
    fac, img, out = B * TRAJ_L * P * side * itemsize, B * P * ch * itemsize, \
        B * TRAJ_L * P * ch * itemsize
    ops = 2 * B * TRAJ_L * P * P * ch
    if backward:
        return 4 * fac + 2 * img + out, 2 * ops
    return 2 * fac + img + out, ops


def bound_ms(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def summed(rows, peak_ops):
    r"""Per-step totals of per-launch rows ``(count, ms, plain_ms, bytes, ops)``
    or ``(count, ms, plain_ms, bytes, ops, library_ms)``."""
    out = dict(ms=sum(n * r[0] for n, *r in rows), plain_ms=sum(n * r[1] for n, *r in rows))
    out["bound_ms"], out["bound_by"] = bound_ms(sum(n * r[2] for n, *r in rows),
                                                sum(n * r[3] for n, *r in rows), peak_ops)
    out["library_ms"] = sum(n * r[4] for n, *r in rows) if all(len(r) == 6 for r in rows) \
        else None
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA card")
    sys.path.insert(0, str(ROOT))
    import vp_suite_tpu_torch
    check(Path(vp_suite_tpu_torch.__file__).resolve().is_relative_to(ROOT),
          f"vp_suite_tpu_torch was imported from {vp_suite_tpu_torch.__file__}, not this checkout")
    from vp_suite_tpu_torch.kernels import build
    import triton

    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tf32_defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton {triton.__version__}, "
          f"python {sys.version.split()[0]}")
    print(decoder_probe())

    t0 = time.time()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        build.build_all(verbose=True)
    print(log.getvalue(), end="")
    print(f"[build] CUDA kernels built in {time.time() - t0:.1f} s")
    check_no_spills(log.getvalue())
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    errs = {}
    suite = serving_suite()
    scan_launches = fused_scan_launches(suite.models[list(PATHS).index("fused_scan")].model)
    gate_inputs = check_gate_kernels(rnd, errs)
    check_scan_forward(rnd, errs)
    scan_inputs = check_scan_backward(rnd, errs, scan_launches)
    warp_inputs = check_warp_kernels(rnd, errs)
    ret_inputs = check_warp_ret(rnd, errs)
    contract_inputs = check_warp_contract(rnd, errs)
    entry_launches = drive_entry_points(ret_inputs, contract_inputs)
    serve = drive_serving(suite, scan_launches)
    train = drive_training()
    drive_suite_test(drive_suite_train(dev))
    drive_file_datasets(dev)

    kernels = time_kernels(serve, train, gate_inputs, scan_inputs, warp_inputs, rnd, errs)
    kernels += time_factor_kernels(ret_inputs, contract_inputs, entry_launches, errs)
    predict_ms = time_paths(serve, train)
    new_times = drive_new_models(dev, tf32_defaults)
    drive_graphs(card, new_times)
    drive_remat(card)
    kernels.append(drive_fvd_loss(card))
    drive_tooling(dev, card, serve, train, predict_ms, new_times)
    drive_parallel(card)
    drive_tensor_parallel(card)
    drive_model_parallel(card)
    print(f"[done] {time.time() - t_start:.0f} s; kernel times below are per predict (K1, K3, "
          f"warp_fwd) or per train step (K2, K3s, K4, warp_bwd), all of their launches, or (K8, "
          f"K9) one call at each of the three layer shapes, in bf16, or (E1) one launch at the "
          f"FVD batch b={B} in f32, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


#: the kernels whose every instantiation must build without spilling: the scan
#: kernels, K8's bf16 kernels, and K9's bf16 forward and general d_A / d_Bm kernel
SPILL_CHECKED = (r"scan_(fwd|bwd)_(bf16|f32)_kernel(I[LiE\d]+E)?",
                 r"warp_ret_(fwd|bwd_img|bwd_dw)_bf16_kernelI[LiE\d]+E",
                 r"contract_(fwd|dab_general)_bf16_kernelI[LiE\d]+E")


def check_no_spills(log):
    r"""Every instantiation of :data:`SPILL_CHECKED` builds without spilling
    registers, as ptxas's ``-v`` report in ``log`` says: they keep their
    accumulators (and the bf16 kernels their A fragments) in registers."""
    spilled, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            for pattern in SPILL_CHECKED:
                kernel = re.search(pattern, name)
                if kernel:
                    spilled[kernel.group(0)] = int(spill.group(1)) + int(spill.group(2))
            name = None
    print("[build] bytes spilled: " + ", ".join(f"{k} {v}" for k, v in sorted(spilled.items())))
    for prefix in ("scan_fwd_bf16", "scan_bwd_bf16", "warp_ret_fwd_bf16", "warp_ret_bwd_img_bf16",
                   "warp_ret_bwd_dw_bf16", "contract_fwd_bf16", "contract_dab_general_bf16"):
        check(any(k.startswith(prefix) for k in spilled),
              f"no -Xptxas -v report of {prefix}_kernel in the build's output")
    check(not any(spilled.values()),
          f"kernels spill registers: {({k: v for k, v in spilled.items() if v})}")


def check_gate_kernels(rnd, errs):
    r"""K1 and K2 against their plain versions; returns the bf16 inputs by shape."""
    import torch
    from vp_suite_tpu_torch.ops.cells import (convlstm_gate_backward,
                                              convlstm_gate_backward_reference,
                                              convlstm_gate_forward, convlstm_gate_reference)
    errs["K1"] = errs["K2"] = 0.0
    inputs = {}
    for side, ch in CELLS:
        base = [rnd(B, side, side, 4 * ch), rnd(B, side, side, ch)] \
            + [rnd(side, side, ch, scale=0.5) for _ in range(3)] \
            + [rnd(B, side, side, ch, scale=0.1), rnd(B, side, side, ch, scale=0.1)]
        for dt in (torch.float32, torch.bfloat16):
            args = [a.to(dt) for a in base]
            inputs[(side, ch, dt)] = args
            for kid, fn, ref, a in (("K1", convlstm_gate_forward, convlstm_gate_reference, args[:5]),
                                    ("K2", convlstm_gate_backward,
                                     convlstm_gate_backward_reference, args)):
                got = fn(*a)
                torch.cuda.synchronize()
                want = ref(*a)
                e = [max_err(g, w) for g, w in zip(got, want)]
                if dt == torch.float32:
                    ok = max(e) <= GATE_ATOL_F32
                    tol = f"atol {GATE_ATOL_F32}"
                else:
                    ok = all(bool(((g.float() - w.float()).abs()
                                   <= GATE_BF16_ULPS * bf16_ulp(w) + GATE_ATOL_F32).all())
                             for g, w in zip(got, want))
                    tol = f"{GATE_BF16_ULPS} bf16 ulps + {GATE_ATOL_F32}"
                    errs[kid] = max(errs[kid], *e)
                ok = ok and all(g.dtype == dt for g in got)
                names = ("h", "c") if kid == "K1" else ("dgates", "dc_in")
                print(f"[{kid}] {side}x{side}x{ch} b={B} {str(dt)[6:]}: "
                      + ", ".join(f"max |{n} err| {x:.3g}" for n, x in zip(names, e))
                      + f" ({tol}): {'ok' if ok else 'FAIL'}")
                check(ok, f"{kid} disagrees with its plain version at {side}x{side}x{ch} {dt}")
    return inputs


def scan_args(rnd, side, enc, steps, with_x, dt):
    import torch
    args = [rnd(steps, B, side, side, 4 * enc, scale=0.3) if with_x else None,
            rnd(B, side, side, enc, scale=0.3), rnd(B, side, side, enc, scale=0.3),
            rnd(3, 3, enc, 4 * enc, scale=(9 * enc) ** -0.5), rnd(4 * enc, scale=0.1)] \
        + [rnd(side, side, enc, scale=0.1) for _ in range(3)]
    return [a if a is None or i == 4 else a.to(dt) for i, a in enumerate(args)]


def check_scan_forward(rnd, errs):
    r"""K3 and K3s against the plain forward; K3s keeps K3's h_seq bit for bit."""
    import torch
    from vp_suite_tpu_torch.ops.convlstm import (convlstm_scan_forward,
                                                 convlstm_scan_forward_reference)
    errs["K3"] = errs["K3s"] = 0.0
    for side, enc in CELLS:
        for steps, with_x in ((10, False), (5, True)):
            base = scan_args(rnd, side, enc, steps, with_x, torch.float32)
            for dt, atol in ((torch.float32, SCAN_ATOL_F32), (torch.bfloat16, SCAN_ATOL_BF16)):
                args = [a if a is None or i == 4 else a.to(dt) for i, a in enumerate(base)]
                seq, c = convlstm_scan_forward(*args, seq_len=steps)
                s_seq, s_c, z, c_prev = convlstm_scan_forward(*args, seq_len=steps,
                                                              save_gates=True)
                torch.cuda.synchronize()
                want = convlstm_scan_forward_reference(*args, seq_len=steps, save_gates=True)
                e3 = [max_err(g, w) for g, w in zip((seq, c), want[:2])]
                e3s = [max_err(g, w) for g, w in zip((s_seq, s_c, z, c_prev), want)]
                same = torch.equal(seq, s_seq) and torch.equal(c, s_c)
                ok = max(e3 + e3s) <= atol and same \
                    and all(t.dtype == dt for t in (seq, c, z, c_prev))
                if dt == torch.bfloat16:
                    errs["K3"] = max(errs["K3"], *e3)
                    errs["K3s"] = max(errs["K3s"], *e3s)
                print(f"[K3/K3s] {side}x{side}x{enc} b={B} T={steps} "
                      f"{'with i2h' if with_x else 'decode'} {str(dt)[6:]}: max err h_seq "
                      f"{e3[0]:.3g}, c_last {e3[1]:.3g}; K3s z {e3s[2]:.3g}, c_prev {e3s[3]:.3g}; "
                      f"h_seq and c_last bit-identical with and without residuals: {same} "
                      f"(atol {atol}): {'ok' if ok else 'FAIL'}")
                check(ok, f"K3/K3s disagree with convlstm_scan_forward_reference at "
                          f"{side}x{side}x{enc} T={steps} with_x={with_x} {dt}")


def fused_scan_launches(model):
    r"""The scan launches of one forward of the fused configuration, in
    order: ``(side, enc, T, with input half)``. Each encoder cell scans the
    context with its input half; the forecaster's first cell scans the
    predicted frames from the encoder's state alone (decode), the others with
    the cell below as input."""
    return [(r.state_h, r.enc_channels, CTX, True) for r in model.enc_rnns_list] \
        + [(r.state_h, r.enc_channels, PRED, i > 0) for i, r in enumerate(model.dec_rnns_list)]


def check_scan_backward(rnd, errs, scan_launches):
    r"""K4 against the plain backward on K3s's residuals, and the scan's eight
    input gradients through its Function against autograd of the plain
    forward, at the fused path's launch shapes. Returns the bf16 residuals
    and cotangents by launch, for the timings."""
    import torch
    from vp_suite_tpu_torch.ops.convlstm import (convlstm_scan_backward,
                                                 convlstm_scan_backward_reference,
                                                 convlstm_scan_forward, convlstm_scan_fused,
                                                 convlstm_scan_reference)
    errs["K4"] = 0.0
    inputs = {}
    names = ("i2h", "h0", "c0", "h_kernel", "bias", "wci", "wcf", "wco")
    for side, enc, steps, with_x in scan_launches:
        base = scan_args(rnd, side, enc, steps, with_x, torch.float32)
        # a mean-type loss: cotangents of the size a loss over b*T frames hands down
        d_seq = rnd(steps, B, side, side, enc, scale=1e-2)
        d_h = rnd(B, side, side, enc, scale=1e-2)
        d_c = rnd(B, side, side, enc, scale=1e-2)
        for dt in (torch.float32, torch.bfloat16):
            args = [a if a is None or i == 4 else a.to(dt) for i, a in enumerate(base)]
            _, _, z, c_prev = convlstm_scan_forward(*args, seq_len=steps, save_gates=True)
            bwd_args = (z, c_prev, d_seq.to(dt), d_c.to(dt), args[3], *args[5:], d_h.to(dt))
            got = convlstm_scan_backward(*bwd_args)
            torch.cuda.synchronize()
            want = convlstm_scan_backward_reference(*bwd_args)
            e4 = [rel_err(g, w) for g, w in zip(got, want)]
            rel = GRAD_REL_F32 if dt == torch.float32 else GRAD_REL_BF16
            ok = max(e4) <= rel and got[0].dtype == dt

            leaves = [None if a is None else a.detach().clone().requires_grad_() for a in args]
            inputs_ = [a for a in leaves if a is not None]
            grads = []
            for fn in (convlstm_scan_fused, convlstm_scan_reference):
                seq, (h, c) = fn(*leaves, seq_len=steps)
                loss = (seq.float() * d_seq).sum() + (h.float() * d_h).sum() \
                    + (c.float() * d_c).sum()
                grads.append(torch.autograd.grad(loss, inputs_))
            e_all = [rel_err(g, w) for g, w in zip(*grads)]
            present = [n for n, a in zip(names, leaves) if a is not None]
            if dt == torch.float32:
                tols = [GRAD_REL_F32_WEIGHT if n == "h_kernel" else GRAD_REL_F32 for n in present]
            else:
                tols = [GRAD_REL_BF16_AUTOGRAD] * len(present)
            ok_all = all(e <= t for e, t in zip(e_all, tols)) \
                and all(g is not None for g in grads[0])
            if dt == torch.bfloat16:
                errs["K4"] = max(errs["K4"], *(max_err(g, w) for g, w in zip(got, want)))
                inputs[(side, enc, steps, with_x)] = bwd_args
            print(f"[K4] {side}x{side}x{enc} b={B} T={steps} {'with i2h' if with_x else 'decode'} "
                  f"{str(dt)[6:]}: dz {e4[0]:.3g}, dh0 {e4[1]:.3g}, dc0 {e4[2]:.3g} (relative "
                  f"to the largest, tol {rel}); the 8 gradients through the Function against "
                  f"autograd of the plain forward: "
                  + ", ".join(f"{n} {x:.3g}" for n, x in zip(present, e_all))
                  + f" (tol {tols[-1]}, h_kernel {tols[present.index('h_kernel')]}): "
                  f"{'ok' if ok and ok_all else 'FAIL'}")
            check(ok, f"K4 disagrees with convlstm_scan_backward_reference at "
                      f"{side}x{side}x{enc} T={steps} {dt}")
            check(ok_all, f"the scan's gradients disagree with autograd of the plain forward at "
                          f"{side}x{side}x{enc} T={steps} {dt}")
    return inputs


def warp_args(rnd, side, ch):
    r"""EF-TrajGRU's warp operands at one layer shape, b=32, L=13, f32:
    indices a few pixels off each output pixel (N(0, 2)), a tenth of them
    sent 0.6 of the image out of it; an image and a cotangent of the size a
    mean-type loss hands down."""
    import torch
    P = side * side
    grid = torch.arange(P, device="cuda")
    oy = (grid // side).float().view(1, P, 1)
    ox = (grid % side).float().view(1, P, 1)
    idx = []
    for o in (oy, ox):
        far = (rnd(B, P, TRAJ_L) > 1.2816).float()          # the top tenth of N(0, 1)
        side_sign = torch.sign(rnd(B, P, TRAJ_L))
        idx.append(o + rnd(B, P, TRAJ_L, scale=2.0) + far * side_sign * 0.6 * side)
    return [*idx, rnd(B, side, side, ch), rnd(B, P, TRAJ_L, ch, scale=1e-2)]


def band_share(iy, ix, h, w, c, bf16=True, forward=False):
    r"""``((taps outside their block's band, taps in the image), tiling)`` of
    the warp backward (or, with ``forward``, the forward) on these indices,
    with the tiling its kernel takes for these sizes on this card
    (``vp_warp_bwd_geometry``, ``vp_warp_fwd_geometry``)."""
    from vp_suite_tpu_torch.kernels import build, warp_bwd_variants, warp_fwd_variants
    b, P, L = iy.shape
    tool = warp_fwd_variants if forward else warp_bwd_variants
    geom = tool.geometry(build.warp_library(), b, P, L, h, w, c, bf16)
    return warp_bwd_variants.out_of_band_share(iy, ix, h, w, geom), geom


@contextlib.contextmanager
def recording_band_shares(shares):
    r"""While active, every backward of ``WarpFunction`` first adds its
    indices' ``(outside, in-image)`` tap counts (:func:`band_share`) to
    ``shares[(h, w, c)]``."""
    import torch
    from vp_suite_tpu_torch.ops.warp import WarpFunction
    plain = WarpFunction.backward

    class Saved:
        r"""``ctx`` with its saved tensors read once: a checkpointed step
        (``remat``) lets a backward read them only once."""

        def __init__(self, ctx, saved):
            self.ctx, self.saved_tensors = ctx, saved

        def __getattr__(self, name):
            return getattr(self.ctx, name)

    def backward(ctx, g):
        iy, ix, img = saved = ctx.saved_tensors
        _, h, w, c = img.shape
        (outside, taps), _ = band_share(iy, ix, h, w, c, img.dtype == torch.bfloat16)
        acc = shares.setdefault((h, w, c), [0, 0])
        acc[0] += outside
        acc[1] += taps
        return plain(Saved(ctx, saved), g)

    WarpFunction.backward = staticmethod(backward)
    try:
        yield shares
    finally:
        WarpFunction.backward = staticmethod(plain)


def check_warp_kernels(rnd, errs):
    r"""The warp's forward and backward kernels against their plain versions,
    and its three gradients through ``WarpFunction`` against autograd of the
    plain forward, at EF-TrajGRU's three layer shapes; returns the bf16
    operands by shape, for the timings."""
    import torch
    from vp_suite_tpu_torch.ops.warp import (warp_sample, warp_sample_backward,
                                             warp_sample_backward_reference,
                                             warp_sample_forward, warp_sample_reference)
    errs["warp_fwd"] = errs["warp_bwd"] = 0.0
    inputs = {}
    names = ("d_iy", "d_ix", "d_img")
    for side, ch in CELLS:
        base = warp_args(rnd, side, ch)
        out_of_image = ((base[0] < 0) | (base[0] > side - 1) | (base[1] < 0)
                        | (base[1] > side - 1)).float().mean().item()
        (outside, taps), geom = band_share(base[0], base[1], side, side, ch)
        print(f"[warp] {side}x{side}x{ch} b={B} L={TRAJ_L}: the backward's tiling in bf16 {geom}; "
              f"{outside} of {taps} in-image taps ({outside / taps:.2%}) fall outside their "
              f"block's band and go to global atomics")
        for dt in (torch.bfloat16, torch.float32):
            (outside, taps), geom = band_share(base[0], base[1], side, side, ch,
                                               dt == torch.bfloat16, forward=True)
            print(f"[warp] {side}x{side}x{ch} b={B} L={TRAJ_L}: the forward's tiling in "
                  f"{str(dt)[6:]} {geom}; {outside} of {taps} in-image taps ({outside / taps:.2%}) "
                  f"fall outside their block's band and are read from global memory")
        for dt in (torch.float32, torch.bfloat16):
            iy, ix, img, g = base[0], base[1], base[2].to(dt), base[3].to(dt)
            got = warp_sample_forward(iy, ix, img)
            torch.cuda.synchronize()
            want = warp_sample_reference(iy, ix, img)
            e_fwd = max_err(got, want)
            if dt == torch.float32:
                ok_fwd = e_fwd <= WARP_ATOL_F32
                tol_fwd = f"atol {WARP_ATOL_F32}"
            else:
                ok_fwd = bool(((got.float() - want.float()).abs()
                               <= WARP_BF16_ULPS * bf16_ulp(want) + WARP_ATOL_F32).all())
                tol_fwd = f"{WARP_BF16_ULPS} bf16 ulp + {WARP_ATOL_F32}"
            ok_fwd = ok_fwd and got.dtype == dt and got.shape == want.shape

            got_b = warp_sample_backward(iy, ix, img, g)
            torch.cuda.synchronize()
            want_b = warp_sample_backward_reference(iy, ix, img, g)
            rel = WARP_GRAD_REL_F32 if dt == torch.float32 else WARP_GRAD_REL_BF16
            e_bwd = [rel_err(q, w) for q, w in zip(got_b, want_b)]
            ok_bwd = max(e_bwd) <= rel and all(q.dtype == w.dtype for q, w in zip(got_b, want_b))

            grads = []
            for fn in (warp_sample, warp_sample_reference):
                leaves = [a.detach().clone().requires_grad_() for a in (iy, ix, img)]
                grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
            e_fn = [rel_err(q, w) for q, w in zip(*grads)]
            ok_fn = max(e_fn) <= rel
            del grads
            if dt == torch.bfloat16:
                errs["warp_fwd"] = max(errs["warp_fwd"], e_fwd)
                errs["warp_bwd"] = max(errs["warp_bwd"], *(max_err(q, w)
                                                           for q, w in zip(got_b, want_b)))
                inputs[(side, ch)] = (iy, ix, img, g)
            print(f"[warp] {side}x{side}x{ch} b={B} L={TRAJ_L} {str(dt)[6:]} "
                  f"({out_of_image:.1%} of the samples out of the image): forward max err "
                  f"{e_fwd:.3g} ({tol_fwd}); backward "
                  + ", ".join(f"{n} {x:.3g}" for n, x in zip(names, e_bwd))
                  + "; through the Function against autograd of the plain forward "
                  + ", ".join(f"{n} {x:.3g}" for n, x in zip(names, e_fn))
                  + f" (relative to the largest, tol {rel:.3g}): "
                  f"{'ok' if ok_fwd and ok_bwd and ok_fn else 'FAIL'}")
            check(ok_fwd, f"the warp forward disagrees with warp_sample_reference at "
                          f"{side}x{side}x{ch} {dt}")
            check(ok_bwd, f"the warp backward disagrees with warp_sample_backward_reference at "
                          f"{side}x{side}x{ch} {dt}")
            check(ok_fn, f"the warp's gradients disagree with autograd of the plain forward at "
                         f"{side}x{side}x{ch} {dt}")
    return inputs


def ret_args(rnd, side, ch):
    r"""K8's operands at one layer shape, b=32, L=13, f32: flows [b, side,
    side, 2L] of a few pixels (N(0, 2)), a tenth of their components sent 0.6
    of the image out of it; an image; ret weights [L, f, 3f] at the scale of
    the conv's init; a bias; a cotangent [b, P, 3f] of the size a mean-type
    loss hands down."""
    import torch
    shape = (B, side, side, 2 * TRAJ_L)
    far = (rnd(*shape) > 1.2816).float()
    flows = rnd(*shape, scale=2.0) + far * torch.sign(rnd(*shape)) * 0.6 * side
    return [flows, rnd(B, side, side, ch), rnd(TRAJ_L, ch, 3 * ch, scale=(TRAJ_L * ch) ** -0.5),
            rnd(3 * ch, scale=0.1), rnd(B, side * side, 3 * ch, scale=1e-2)]


def report(tag, parts, ok):
    r"""One result line: ``parts`` are ``(label, {name: error}, tolerance)``."""
    print(f"[{tag}] " + "; ".join(f"{label} " + ", ".join(f"{n} {e:.3g}" for n, e in es.items())
                                 + f" (tol {tol:.3g})" for label, es, tol in parts)
          + f": {'ok' if ok else 'FAIL'}")


def check_warp_ret(rnd, errs):
    r"""K8's forward and backward kernels against their plain versions, its
    five gradients through ``WarpRetFunction`` against autograd of the plain
    forward, and ``warp_ret`` against ``warp_flow_ret`` (the warp kernel and a
    cuBLAS GEMM, the unfused path TrajGRU runs) for the output and the five
    gradients, at EF-TrajGRU's three layer shapes in f32 and bf16; returns the
    bf16 operands by shape, for the timings."""
    import torch
    from vp_suite_tpu_torch.ops.grid_sample import _flow_to_indices, warp_flow_ret
    from vp_suite_tpu_torch.ops.warp import (warp_ret, warp_ret_backward,
                                             warp_ret_backward_reference, warp_ret_forward,
                                             warp_ret_reference)
    from vp_suite_tpu_torch.kernels import build, k8_variants
    errs["warp_ret_fwd"] = errs["warp_ret_bwd"] = 0.0
    names = ("d_iy", "d_ix", "d_img", "d_w", "d_bias")
    inputs = {}
    props = torch.cuda.get_device_properties(0)
    limits = (props.multi_processor_count,
              getattr(props, "shared_memory_per_block_optin", k8_variants.H100_LIMITS[1]))
    for side, ch in CELLS:
        got = k8_variants.geometry(build.warp_ret_library(), B, side * side, TRAJ_L, side, side, ch,
                                   3 * ch)
        want = k8_variants.plan(B, side * side, TRAJ_L, side, side, ch, 3 * ch, limits=limits)
        print(f"[K8] {side}x{side}x{ch} b={B} L={TRAJ_L} O={3 * ch}: the bf16 kernels' plan {got}")
        check(got == want, f"K8's plan at {side}x{side}x{ch} is not its Python mirror {want}")
        flows, img0, w, bias, g0 = ret_args(rnd, side, ch)
        iy, ix = _flow_to_indices(img0, flows)
        for dt in (torch.float32, torch.bfloat16):
            img, g = img0.to(dt), g0.to(dt)
            got = warp_ret_forward(iy, ix, img, w, bias)
            got_b = warp_ret_backward(iy, ix, img, w, bias, g)
            torch.cuda.synchronize()
            want = warp_ret_reference(iy, ix, img, w, bias)
            want_b = warp_ret_backward_reference(iy, ix, img, w, bias, g)
            e_k = {"out": rel_err(got, want), **{n: rel_err(q, r)
                                                 for n, q, r in zip(names, got_b, want_b)}}
            typed = got.dtype == dt and got.shape == want.shape \
                and all(q.dtype == r.dtype and q.shape == r.shape for q, r in zip(got_b, want_b))

            grads = []
            for fn in (warp_ret, warp_ret_reference):
                leaves = [a.detach().clone().requires_grad_() for a in (iy, ix, img, w, bias)]
                grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
            e_fn = {n: rel_err(q, r) for n, q, r in zip(names, *grads)}

            # the unfused path on the same image, flows, weights and bias; the
            # flows' gradient holds d_ix (its even channels) and d_iy (odd)
            outs, grads = [], []
            for fused in (True, False):
                im, fl, wl, bl = (a.detach().clone().requires_grad_()
                                  for a in (img, flows, w, bias))
                if fused:
                    out = warp_ret(*_flow_to_indices(im, fl), im, wl, bl)
                else:
                    out = warp_flow_ret(im, fl, wl.view(-1, 3 * ch), bl).view(B, -1, 3 * ch)
                d_img, d_fl, d_w, d_b = torch.autograd.grad(out, (im, fl, wl, bl), g)
                outs.append(out.detach())
                grads.append((d_fl[..., 1::2], d_fl[..., 0::2], d_img, d_w, d_b))
            e_flow = {"out": rel_err(*outs), **{n: rel_err(q, r) for n, q, r in zip(names, *grads)}}
            del grads, outs

            f32 = dt == torch.float32
            rel = RET_REL_F32 if f32 else FACTOR_REL_BF16
            rel_flow = FLOW_RET_REL_F32 if f32 else FLOW_RET_REL_BF16
            ok = typed and max(*e_k.values(), *e_fn.values()) <= rel \
                and max(e_flow.values()) <= rel_flow
            if not f32:
                errs["warp_ret_fwd"] = max(errs["warp_ret_fwd"], max_err(got, want))
                errs["warp_ret_bwd"] = max(errs["warp_ret_bwd"], *(max_err(q, r)
                                                                   for q, r in zip(got_b, want_b)))
                inputs[(side, ch)] = (iy, ix, img, w, bias, g, flows)
            report(f"K8 warp_ret {side}x{side}x{ch} b={B} L={TRAJ_L} O={3 * ch} {str(dt)[6:]}",
                   [("kernels against the plain versions", e_k, rel),
                    ("through the Function against autograd of the plain forward", e_fn, rel),
                    ("warp_ret against warp_flow_ret", e_flow, rel_flow)], ok)
            check(ok, f"warp_ret disagrees at {side}x{side}x{ch} {dt} (errors relative to the "
                      f"largest of each kind)")
    return inputs


def check_warp_contract(rnd, errs):
    r"""K9's forward and backward kernels against their plain versions on
    dense random factors, and its three gradients through
    ``WarpContractFunction`` against autograd of the plain forward (on the
    first four batch items: autograd saves a [b, P, w, c] f32 intermediate
    per flow), at EF-TrajGRU's three layer shapes in f32 and bf16; and the
    one-hot route, ``warp_contract`` on ``_onehot_factor``s, against
    ``warp_sample`` (K5) in f32. Returns the bf16 operands by shape."""
    import torch
    from vp_suite_tpu_torch.ops.grid_sample import _onehot_factor
    from vp_suite_tpu_torch.ops.warp import (warp_contract, warp_contract_backward,
                                             warp_contract_backward_reference,
                                             warp_contract_forward, warp_contract_reference,
                                             warp_sample)
    errs["warp_contract_fwd"] = errs["warp_contract_bwd"] = 0.0
    names = ("d_A", "d_Bm", "d_img")
    inputs = {}
    for side, ch in CELLS:
        P = side * side
        # dense factors at the one-hot factors' scale: out is of order 1
        base = [rnd(B, TRAJ_L, P, side, scale=side ** -0.5), rnd(B, TRAJ_L, P, side,
                                                                scale=side ** -0.5),
                rnd(B, side, side, ch), rnd(B, TRAJ_L, P, ch, scale=1e-2)]
        for dt in (torch.float32, torch.bfloat16):
            A, Bm, img, g = (a.to(dt) for a in base)
            got = warp_contract_forward(A, Bm, img)
            got_b = warp_contract_backward(A, Bm, img, g)
            torch.cuda.synchronize()
            want = warp_contract_reference(A, Bm, img)
            want_b = warp_contract_backward_reference(A, Bm, img, g)
            e_k = {"out": rel_err(got, want), **{n: rel_err(q, r)
                                                 for n, q, r in zip(names, got_b, want_b)}}
            typed = got.dtype == dt and got.shape == want.shape \
                and all(q.dtype == dt and q.shape == r.shape for q, r in zip(got_b, want_b))
            e_abs = [max_err(got, want)] + [max_err(q, r) for q, r in zip(got_b, want_b)]
            del want, want_b
            grads = []
            for fn in (warp_contract, warp_contract_reference):
                leaves = [a[:4].detach().clone().requires_grad_() for a in (A, Bm, img)]
                grads.append(torch.autograd.grad(fn(*leaves), leaves, g[:4]))
            e_fn = {n: rel_err(q, r) for n, q, r in zip(names, *grads)}
            del grads
            rel = CONTRACT_REL_F32 if dt == torch.float32 else FACTOR_REL_BF16
            ok = typed and max(*e_k.values(), *e_fn.values()) <= rel
            parts = [("kernels against the plain versions", e_k, rel),
                     ("through the Function against autograd of the plain forward (b=4)", e_fn,
                      rel)]
            if dt == torch.float32:
                iy, ix, im, _ = warp_args(rnd, side, ch)
                onehot = warp_contract(_onehot_factor(iy.transpose(1, 2), side, dt),
                                       _onehot_factor(ix.transpose(1, 2), side, dt), im)
                e_hot = max_err(onehot.transpose(1, 2), warp_sample(iy, ix, im))
                ok = ok and e_hot <= ONEHOT_ATOL_F32
                parts.append(("one-hot warp_contract against warp_sample, absolute",
                              {"out": e_hot}, ONEHOT_ATOL_F32))
                del onehot
            else:
                errs["warp_contract_fwd"] = max(errs["warp_contract_fwd"], e_abs[0])
                errs["warp_contract_bwd"] = max(errs["warp_contract_bwd"], *e_abs[1:])
                inputs[(side, ch)] = (A, Bm, img, g)
            report(f"K9 warp_contract {side}x{side}x{ch} b={B} L={TRAJ_L} {str(dt)[6:]}", parts,
                   ok)
            check(ok, f"warp_contract disagrees at {side}x{side}x{ch} {dt} (errors relative to "
                      f"the largest of each kind)")
    # beyond the layer shapes, bf16: a wide image and a tall one
    for b, Lf, P, h, w, c in CONTRACT_EXTRA:
        A, Bm = rnd(b, Lf, P, h, scale=h ** -0.5, dtype=torch.bfloat16), \
            rnd(b, Lf, P, w, scale=w ** -0.5, dtype=torch.bfloat16)
        img, g = rnd(b, h, w, c, dtype=torch.bfloat16), rnd(b, Lf, P, c, scale=1e-2,
                                                            dtype=torch.bfloat16)
        got = [warp_contract_forward(A, Bm, img), *warp_contract_backward(A, Bm, img, g)]
        torch.cuda.synchronize()
        want = [warp_contract_reference(A, Bm, img), *warp_contract_backward_reference(A, Bm, img, g)]
        e_k = {n: rel_err(q, r) for n, q, r in zip(("out",) + names, got, want)}
        ok = max(e_k.values()) <= FACTOR_REL_BF16 and all(q.dtype == torch.bfloat16
                                                          and q.shape == r.shape
                                                          for q, r in zip(got, want))
        report(f"K9 warp_contract b={b} L={Lf} P={P} {h}x{w}x{c} bf16",
               [("kernels against the plain versions", e_k, FACTOR_REL_BF16)], ok)
        check(ok, f"bf16 warp_contract disagrees at b={b} L={Lf} P={P} {h}x{w}x{c}")
    return inputs


def drive_entry_points(ret_inputs, contract_inputs):
    r"""K8's and K9's path: ``warp_ret`` and ``warp_contract`` forward and
    backward through autograd, once at each layer shape in bf16, with the
    launch counts set to 0 just before and read just after; returns them."""
    import torch
    from vp_suite_tpu_torch.ops.warp import warp_contract, warp_ret
    counters = reset_counts()
    for key, (iy, ix, img, w, bias, g, _) in ret_inputs.items():
        leaves = [a.detach().clone().requires_grad_() for a in (iy, ix, img, w, bias)]
        grads = torch.autograd.grad(warp_ret(*leaves), leaves, g)
        check(all(bool(torch.isfinite(d).all()) for d in grads),
              f"warp_ret at {key}: non-finite gradients")
    for key, (A, Bm, img, g) in contract_inputs.items():
        leaves = [a.detach().clone().requires_grad_() for a in (A, Bm, img)]
        grads = torch.autograd.grad(warp_contract(*leaves), leaves, g)
        check(all(bool(torch.isfinite(d).all()) for d in grads),
              f"warp_contract at {key}: non-finite gradients")
    torch.cuda.synchronize()
    launches = read_counts(counters)
    print("[entry points] warp_ret and warp_contract with their gradients at the three layer "
          "shapes, bf16: kernel launches " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(launches == WANT_ENTRY_LAUNCHES,
          f"the entry points launched {launches}, not {WANT_ENTRY_LAUNCHES}")
    return launches


def create_models(suite, **kw):
    r"""One model per path in ``suite``, at 64x64 RGB from the seed; returns
    their indices by path."""
    for model_id, cfg in PATHS.values():
        suite.create_model(model_id, img_shape=IMG, action_size=0, tensor_value_range=(0.0, 1.0),
                           seed=SEED, **kw, **cfg)
    return {name: i for i, name in enumerate(PATHS)}


def serving_suite():
    r"""A ``VPSuite`` on the card with one model per path, in bf16."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    suite = VPSuite()
    create_models(suite, compute_dtype=torch.bfloat16)
    return suite


def drive_serving(suite, scan_launches):
    r"""``predict`` on each path, with the kernels counted around each call."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    frames = torch.rand((B, CTX, IMG[1], IMG[2], IMG[0]),
                        generator=torch.Generator().manual_seed(SEED))

    preds, launches = {}, {}
    for i, name in enumerate(PATHS):
        counters = reset_counts()
        preds[name] = suite.predict(frames, pred_frames=PRED, model_idx=i)
        torch.cuda.synchronize()
        launches[name] = read_counts(counters)
        print(f"[predict] {name}: kernel launches in one predict: "
              + ", ".join(f"{k} {v}" for k, v in launches[name].items()))
        check(launches[name] == WANT_PREDICT_LAUNCHES[name],
              f"{name}: one predict launched {launches[name]}, not {WANT_PREDICT_LAUNCHES[name]}")
    check(launches["fused_scan"]["K3"] == len(scan_launches),
          f"the fused-scan serving path launched K3 {launches['fused_scan']['K3']} times, not "
          f"once for each of its {len(scan_launches)} scans {scan_launches}")

    want_shape = (B, PRED, IMG[1], IMG[2], IMG[0])
    for name, p in preds.items():
        check(tuple(p.shape) == want_shape and p.dtype == torch.float32
              and p.device.type == "cuda",
              f"{name}: predict gave {tuple(p.shape)} {p.dtype} on {p.device}")
        check(bool(torch.isfinite(p).all()), f"{name}: predict gave non-finite values")
        print(f"[predict] {name}: {tuple(p.shape)} float32, finite, "
              f"|pred| max {p.abs().max().item():.3g}, mean {p.abs().mean().item():.3g}")
    d_ab = (preds["per_step"] - preds["fused_scan"]).abs().max().item()
    print(f"[predict] per_step vs fused_scan, bf16, b={B}: max diff {d_ab:.3g} "
          f"(atol {PREDICT_ATOL_BF16})")
    check(d_ab <= PREDICT_ATOL_BF16, "per-step and fused-scan predictions disagree")

    cpu_suite, f32_suite = VPSuite(device="cpu"), VPSuite()
    create_models(cpu_suite)
    create_models(f32_suite, compute_dtype=torch.float32)
    for i, name in enumerate(PATHS):
        ref = cpu_suite.predict(frames[:2], pred_frames=PRED, model_idx=i)
        d32 = (f32_suite.predict(frames[:2], pred_frames=PRED, model_idx=i).cpu() - ref)
        d32 = d32.abs().max().item()
        d16 = (preds[name][:2].cpu() - ref).abs().max().item()
        print(f"[predict] {name} b=2 against the CPU in f32: card f32 max diff {d32:.3g} "
              f"(atol {PREDICT_ATOL_F32}), card bf16 max diff {d16:.3g} "
              f"(atol {PREDICT_ATOL_BF16}); |pred| max {ref.abs().max().item():.3g}")
        check(d32 <= PREDICT_ATOL_F32, f"{name}: f32 predict on the card disagrees with the CPU")
        check(d16 <= PREDICT_ATOL_BF16, f"{name}: bf16 predict on the card disagrees with the CPU")
    return dict(suite=suite, frames=frames, launches=launches, scan_launches=scan_launches)


def reset_counts():
    r"""Sets every kernel's launch count to 0; returns the counters by kernel id."""
    from vp_suite_tpu_torch.ops.cells import convlstm_gate_backward, convlstm_gate_fuse
    from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_backward, convlstm_scan_fused
    from vp_suite_tpu_torch.ops.sym_eig import sym_eig
    from vp_suite_tpu_torch.ops.warp import (warp_contract_backward, warp_contract_forward,
                                             warp_ret_backward, warp_ret_forward, warp_sample,
                                             warp_sample_backward)
    counters = {"K1": (convlstm_gate_fuse, "launches"), "K2": (convlstm_gate_backward, "launches"),
                "K3": (convlstm_scan_fused, "launches"),
                "K3s": (convlstm_scan_fused, "save_gates_launches"),
                "K4": (convlstm_scan_backward, "launches"),
                "warp_fwd": (warp_sample, "launches"),
                "warp_bwd": (warp_sample_backward, "launches"),
                "warp_ret_fwd": (warp_ret_forward, "launches"),
                "warp_ret_bwd": (warp_ret_backward, "launches"),
                "warp_contract_fwd": (warp_contract_forward, "launches"),
                "warp_contract_bwd": (warp_contract_backward, "launches"),
                "E1": (sym_eig, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    return counters


def read_counts(counters):
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def unused_parameters(model):
    r"""Names of the parameters that no path through ``model`` uses: the
    input-side convs of EF-TrajGRU's first forecaster block, which runs in
    decode mode (zero input), as the JAX package's and the reference's do."""
    decode = model.dec_rnns_list[0]
    convs = [getattr(decode, n) for n in ("i2h", "i2f_conv1") if hasattr(decode, n)]
    ids = {id(p) for conv in convs for p in conv.parameters()}
    return {name for name, p in model.named_parameters() if id(p) in ids}


def drive_training():
    r"""The training path on each path's model, eager (``use_jit=False``;
    :func:`drive_graphs` holds the compiled step): Adam at lr 1e-4 on one fixed
    b=32 batch of 15 frames, 2 warm-up and 5 timed steps, with the kernels'
    launch counts read around the first step; then one f32 SGD step at b=2 on
    the card against the CPU."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    run_config = {"context_frames": CTX, "pred_frames": PRED}
    frames = torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]),
                        generator=torch.Generator().manual_seed(SEED + 1)).cuda()
    batch = {"frames": frames}
    out = dict(batch=batch, steps={}, launches={})
    suite = VPSuite()
    create_models(suite, compute_dtype=torch.bfloat16)
    for i, name in enumerate(PATHS):
        model = suite.models[i].model
        state = create_train_state(model, lr=LR, seed=SEED)
        step = make_train_step(model, run_config, use_jit=False)
        torch.cuda.synchronize()
        counters = reset_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = out["launches"][name] = read_counts(counters)
        print(f"[train] {name}: kernel launches in one train step: "
              + ", ".join(f"{k} {v}" for k, v in launches.items()))
        check(launches == WANT_TRAIN_LAUNCHES[name],
              f"{name}: one train step launched {launches}, not {WANT_TRAIN_LAUNCHES[name]}")
        unused = unused_parameters(model)
        for pname, p in model.named_parameters():
            if pname in unused:
                check(p.grad is None, f"{name}: unused parameter {pname} has a gradient")
                continue
            check(p.grad is not None and p.grad.dtype == torch.float32
                  and bool(torch.isfinite(p.grad).all()) and bool((p.grad != 0).any()),
                  f"{name}: parameter {pname} has no finite, non-zero f32 gradient after a step")
        losses = [float(metrics["total"])]
        with recording_band_shares({}) as shares:
            state, metrics = step(state, batch)
            losses.append(float(metrics["total"]))
        if shares:
            print(f"[train] {name}: taps of the warp backward outside their block's band, from "
                  f"the indices of one train step (not timed): "
                  + ", ".join(f"{h}x{w}x{c} {o} of {n} ({o / n:.2%})"
                              for (h, w, c), (o, n) in shares.items()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["total"]))   # waits for the card
            times.append(time.perf_counter() - t0)
        peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
        check(all(map(math.isfinite, losses)),
              f"{name}: non-finite training loss {losses}")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall over 7 steps: {losses}")
        check(state.step == 7, f"{name}: the state counts {state.step} steps, not 7")
        lat = sorted(times)[len(times) // 2] * 1e3
        fwd = forward_ms(model, batch)
        print(f"[train] {name} bf16 b={B} {CTX}->{PRED} at 64x64, Adam lr {LR}: losses "
              + ", ".join(f"{x:.2f}" for x in losses)
              + f"; median step {lat:.2f} ms (steps {', '.join(f'{t * 1e3:.2f}' for t in times)}), "
              f"{B * (CTX + PRED) / lat * 1e3:.0f} frames/s, peak memory {peak:.2f} GiB above "
              f"what was live before (parameters, gradients, Adam's moments); "
              f"forward and loss alone {fwd:.2f} ms, so backward and update {lat - fwd:.2f} ms")
        out["steps"][name] = dict(model=model, state=state, step=step, lat=lat, peak=peak)

    # one f32 SGD step at b=2 on the card against the CPU, as (p0 - p1) / lr
    lr = 1e-2
    small = {"frames": frames[:2]}
    steps = {}
    for device, kw in (("cuda", dict(compute_dtype=torch.float32)), ("cpu", {})):
        models = VPSuite(device=device)
        create_models(models, **kw)
        for i, name in enumerate(PATHS):
            model = models.models[i].model
            p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
            state = create_train_state(model, lr=lr, optimizer="sgd")
            _, metrics = make_train_step(model, run_config)(
                state, {"frames": small["frames"].to(device)})
            steps[(name, device)] = (float(metrics["total"]),
                                     {k: ((p0[k] - v.detach()) / lr).cpu()
                                      for k, v in model.named_parameters()})
    for name in PATHS:
        card, host = steps[(name, "cuda")], steps[(name, "cpu")]
        worst, worst_name = 0.0, ""
        for k, want in host[1].items():
            excess = ((card[1][k] - want).abs() - STEP_TOL * want.abs()).max().item()
            if excess > worst or not worst_name:
                worst, worst_name = excess, k
        d_loss = abs(card[0] - host[0])
        ok = worst <= STEP_TOL and d_loss <= 1e-4 * abs(host[0])
        print(f"[train] {name} f32 b=2 SGD step, card against CPU: loss {card[0]:.6f} vs "
              f"{host[0]:.6f}; (p0-p1)/lr: max(|diff| - rtol*|cpu|) {worst:.3g} at "
              f"{worst_name} (rtol {STEP_TOL}, must stay <= atol {STEP_TOL}): "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: one f32 SGD step on the card disagrees with the CPU")
    return out



def drive_suite_train(dev):
    r"""The facade's training path: ``VPSuite()`` -> ``load_dataset("MMF",
    digit_source="synthetic", img_size=64, ...)`` -> ``create_model`` in bf16
    (width and depth from the dataset) -> ``train`` (b=32, 5 -> 10) for each
    of ``SUITE_RUNS``, with the launch counts set to 0 just before each
    ``train`` and held exactly just after; prints each epoch's frames/s and
    checks the losses, the checkpoints (``load_model`` and ``predict``), one
    batch of the host path through ``device_prefetch`` and the card's batch
    generator; then one more device-backend epoch under the profiler.
    Returns the run directories of the first device-backend run of each
    path, for :func:`drive_suite_test`, which deletes them."""
    import shutil
    import numpy as np
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.datasets.mmnist_device import DeviceBatchIterator, render, sample
    from vp_suite_tpu_torch.training.data import BatchLoader, device_prefetch
    out_root = ROOT / "vp-suite-data" / "chip_smoke"
    shutil.rmtree(out_root, ignore_errors=True)
    frames = torch.rand((B, CTX, IMG[1], IMG[2], IMG[0]),
                        generator=torch.Generator().manual_seed(SEED + 2))
    run_kw = dict(batch_size=B, context_frames=CTX, pred_frames=PRED, no_vis=True,
                  no_wandb=True)
    run_dirs = {}
    for i, (path, backend, epochs, steps) in enumerate(SUITE_RUNS):
        name = f"{path} {backend}"
        out = out_root / f"run{i}"
        if backend == "device":
            run_dirs.setdefault(path, out)
        suite = VPSuite()
        suite.load_dataset("MMF", digit_source="synthetic", img_size=IMG[1], backend=backend,
                           n_seqs={"train": B * steps, "val": B, "test": B})
        entry = suite.create_model(PATHS[path][0], compute_dtype=torch.bfloat16, seed=SEED,
                                   **PATHS[path][1])
        check(entry.model.img_shape == IMG, f"{name}: the model took img_shape "
              f"{entry.model.img_shape} from the dataset, not {IMG}")
        torch.cuda.synchronize()
        counters = reset_counts()
        best = suite.train(epochs=epochs, steps_per_epoch=steps, out_dir=str(out), **run_kw)
        torch.cuda.synchronize()
        launches, want = read_counts(counters), want_suite_launches(path, epochs, steps)
        print(f"[suite] train {name}, {epochs} epoch(s) of {steps} steps: kernel launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items()))
        check(launches == want, f"{name}: train launched {launches}, not {want}")
        with open(out / "metrics.jsonl") as f:
            val = [json.loads(line)["mse"] for line in f]
        check(len(val) == epochs and all(map(math.isfinite, val)) and math.isfinite(best),
              f"{name}: validation losses {val}, best {best}")
        check(entry.state.step == epochs * steps,
              f"{name}: the state counts {entry.state.step} steps, not {epochs * steps}")
        print(f"[suite] train {name} bf16 b={B} {CTX}->{PRED} at {IMG[1]}x{IMG[2]}: "
              f"frames/s per epoch "
              + ", ".join(f"{x:.1f}" for x in entry.train_epoch_fps)
              + f" (last epoch {entry.train_epoch_fps[-1]:.1f}); validation MSE per epoch "
              + ", ".join(f"{x:.2f}" for x in val) + f", best {best:.2f}")

        # the saved model: final_model is the entry's state, and so is
        # best_model where the last epoch was the best
        ckpt = "best_model" if val[-1] == best else "final_model"
        loaded = VPSuite().load_model(str(out), ckpt)
        d = (loaded.model.state_dict(), entry.model.state_dict())
        check(all(torch.equal(d[0][k], d[1][k]) for k in d[1]) and loaded.state.step > 0,
              f"{name}: load_model({ckpt}) did not restore the trained parameters")
        suite.models.append(loaded)
        want_pred = suite.predict(frames, pred_frames=PRED, model_idx=-2)
        got_pred = suite.predict(frames, pred_frames=PRED, model_idx=-1)
        diff = (got_pred - want_pred).abs().max().item()
        print(f"[suite] {name}: load_model({ckpt}) predict against the trained entry's: "
              f"max diff {diff:.3g}")
        check(diff == 0.0, f"{name}: the loaded model predicts other frames")

        if backend == "numpy":
            data = suite.datasets[-1].train_data
            data.reset_rng()
            host = next(iter(BatchLoader(data, B, uint8_frames=True, num_workers=1)))
            data.reset_rng()
            card = next(iter(device_prefetch(BatchLoader(data, B, uint8_frames=True,
                                                         num_workers=1), suite.device)))
            check(card["frames"].device == suite.device and card["frames"].dtype == torch.uint8
                  and np.array_equal(card["frames"].cpu().numpy(), host["frames"])
                  and np.array_equal(card["actions"].cpu().numpy(), host["actions"]),
                  f"{name}: a batch through device_prefetch is not the loader's batch")
            print(f"[suite] {name}: one uint8 batch {tuple(host['frames'].shape)} through "
                  f"device_prefetch equals the loader's")
        else:
            epoch = B * (CTX + PRED) * steps / entry.train_epoch_fps[-1] * 1e3
            busy, _ = profile(f"train epoch {name} ({steps} steps, no validation)",
                              lambda: suite.train(epochs=1, steps_per_epoch=steps, no_val=True,
                                                  out_dir=str(out), model_idx=0, **run_kw))
            profiled = B * (CTX + PRED) * steps / entry.train_epoch_fps[-1] * 1e3
            if busy:
                print(f"[suite] {name}: {busy:.1f} ms of device time in an epoch of {steps} "
                      f"steps: busy {busy / profiled:.0%} of the profiled epoch's "
                      f"{profiled:.1f} ms; {busy / epoch:.0%} of the {epoch:.1f} ms of the "
                      f"last epoch above, which ran without the profiler")

    # the card's generator: its distributions and its determinism
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ids, pos0, speed0 = sample(gen, 100, batch=4096, num_digits=2, img_size=IMG[1],
                               digit_size=28, min_speed=2, max_speed=5)
    speeds = set(speed0.unique().tolist())
    positions = (pos0.min().item(), pos0.max().item())
    templates = torch.rand((100, 28, 28), generator=torch.Generator().manual_seed(SEED))
    batch = render(templates.to(dev), ids[:B], pos0[:B], speed0[:B], seq_len=CTX + PRED,
                   img_size=IMG[1], num_channels=IMG[0])
    kw = dict(batch_size=4, seq_len=CTX + PRED, img_size=IMG[1], num_channels=IMG[0],
              num_digits=2, min_speed=2, max_speed=5, value_range=(0.0, 1.0), n_steps=2,
              seed=SEED, device=dev)
    bank = (templates.numpy() * 255).astype(np.uint8)
    same = all(torch.equal(a["frames"], b["frames"])
               for a, b in zip(DeviceBatchIterator(bank, **kw), DeviceBatchIterator(bank, **kw)))
    print(f"[suite] card generator: speeds {sorted(speeds)}, start positions in "
          f"[{positions[0]}, {positions[1]}], ids in [{ids.min().item()}, {ids.max().item()}], "
          f"frames in [{batch.min().item():.3g}, {batch.max().item():.3g}], same seed same "
          f"batches: {same}")
    check(speeds == {-5, -4, -3, -2, 2, 3, 4, 5}, f"card generator speeds {sorted(speeds)}")
    check(positions == (0, IMG[1] - 28 - 1), f"card generator start positions in {positions}")
    check(ids.min().item() >= 0 and ids.max().item() < 100, "card generator template ids")
    check(batch.min().item() >= 0.0 and batch.max().item() <= 1.0, "card generator values")
    check(same, "the card generator gives other batches for the same seed")
    return run_dirs


def drive_suite_test(run_dirs):
    r"""The facade's test path on each path's checkpoint (``run_dirs``, from
    :func:`drive_suite_train`), each in a suite of its own, with PyTorch's
    default TF32 flags; deletes the runs at the end."""
    import shutil
    import numpy as np
    import torch
    import vp_suite_tpu_torch.vpsuite as port_vpsuite
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.defaults import SETTINGS
    from vp_suite_tpu_torch.measure import METRIC_CLASSES
    from vp_suite_tpu_torch.measure.metric_provider import PredictionMetricProvider
    from vp_suite_tpu_torch.training.data import BatchLoader
    t_phase = time.time()
    out_root = ROOT / "vp-suite-data" / "chip_smoke"
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    smoke_flags, smoke_run_path = (cudnn.allow_tf32, matmul.allow_tf32), SETTINGS._run_path
    cudnn.allow_tf32, matmul.allow_tf32 = True, False     # PyTorch's defaults
    test_kw = dict(brief_test=True, context_frames=CTX, pred_frames=PRED, metrics="all",
                   no_vis=True, no_wandb=True)
    first_pair = None
    for path, run_dir in run_dirs.items():
        suite = VPSuite()
        entry = suite.load_model(str(run_dir), "best_model")
        check(entry.model.compute_dtype == torch.bfloat16 and entry.model.img_shape == IMG,
              f"{path}: load_model gave a {entry.model.compute_dtype} model of "
              f"{entry.model.img_shape}")
        suite.load_dataset("MMF", split="test", img_size=IMG[1], digit_source="synthetic",
                           n_seqs=TEST_SEQS)
        SETTINGS._run_path = run_dir / "test_runs"
        batches = []

        class RecordingLoader(BatchLoader):   # the test's batches, in the order consumed
            def __iter__(self):
                for batch in super().__iter__():
                    batches.append(batch)
                    yield batch

        port_vpsuite.BatchLoader = RecordingLoader
        pairs = []
        get_metrics = PredictionMetricProvider.get_metrics

        def recording(self, pred, target, **kw):
            pairs.append((pred, target))
            return get_metrics(self, pred, target, **kw)

        PredictionMetricProvider.get_metrics = recording
        try:
            torch.cuda.synchronize()
            counters = reset_counts()
            t0 = time.perf_counter()
            (results,) = suite.test(**test_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts(counters)
        finally:
            port_vpsuite.BatchLoader = BatchLoader
            PredictionMetricProvider.get_metrics = get_metrics
        print(f"[suite] test {path}: kernel launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items()))
        check(launches == WANT_TEST_LAUNCHES[path],
              f"{path}: test launched {launches}, not {WANT_TEST_LAUNCHES[path]}")
        check(cudnn.allow_tf32 and not matmul.allow_tf32,
              f"{path}: test left the TF32 flags at {cudnn.allow_tf32}, {matmul.allow_tf32}")
        print(f"[suite] test {path} bf16 {CTX}->{PRED} at {IMG[1]}x{IMG[2]}, metrics='all', "
              f"{TEST_BATCHES} batches of 1 for {len(results)} models: {wall:.2f} s "
              f"({wall / TEST_BATCHES * 1e3:.1f} ms per batch, both models and all measures)")

        # every horizon's measures, FVD from 9 frames on
        check(list(results) == [entry.NAME, "CopyLastFrame"],
              f"{path}: test results for {list(results)}")
        every = [f"{k} ({'↑' if METRIC_CLASSES[k].BIGGER_IS_BETTER else '↓'})"
                 for k in METRIC_CLASSES if k != "fvd"]
        for name, horizons in results.items():
            check(len(horizons) == PRED, f"{path}: {name} has {len(horizons)} horizons")
            for h, d in enumerate(horizons, 1):
                want_keys = every + (["fvd (↓)"] if h >= 9 else [])
                check(list(d) == want_keys and all(map(math.isfinite, d.values())),
                      f"{path}: {name} at horizon {h}: {d}")
            print(f"[suite] test {path}: {name} at horizons 1 / 5 / 10: "
                  + " / ".join(", ".join(f"{k.split()[0]} {v:.4g}" for k, v in horizons[h].items())
                               for h in (0, 4, 9)))

        # CopyLastFrame's rows against the same batches: mse and psnr in f64 on
        # the host, every measure through a new provider on the card
        frames = [torch.from_numpy(b["frames"]) for b in batches[:TEST_BATCHES]]
        check(len(pairs) == 2 * TEST_BATCHES and all(
            torch.equal(t.cpu(), f[:, CTX:CTX + PRED]) for (_, t), f in
            zip(pairs[1::2], frames)), f"{path}: the recorded batches are not the test's")
        ctx_last = [f[:, CTX - 1:CTX].double() for f in frames]
        err = [(f[:, CTX:CTX + PRED].double() - c) ** 2 for f, c in zip(frames, ctx_last)]
        mse = np.mean([e.sum(dim=(2, 3, 4))[0].cumsum(0).numpy() / np.arange(1, PRED + 1)
                       for e in err], axis=0)
        psnr = np.mean([(-10 * torch.log10(e.mean(dim=(2, 3, 4))[0])).cumsum(0).numpy()
                        / np.arange(1, PRED + 1) for e in err], axis=0)
        provider = PredictionMetricProvider({"metrics": "all", "img_c": IMG[0]})
        again = [provider.get_metrics(c.float().repeat(1, PRED, 1, 1, 1).to(suite.device),
                                      f[:, CTX:CTX + PRED].to(suite.device), all_frame_cnts=True)
                 for f, c in zip(frames, ctx_last)]
        worst = 0.0
        for h, d in enumerate(results["CopyLastFrame"]):
            want = {k: np.mean([a[h][k] for a in again]) for k in d}
            for k, v in d.items():
                own = (lambda x: 1.0 - x) if k.startswith("ssim") else (lambda x: x)
                worst = max(worst, abs(own(v) - own(want[k])) / abs(own(want[k])))
            worst = max(worst, abs(d["mse (↓)"] - mse[h]) / mse[h],
                        abs(d["psnr (↑)"] - psnr[h]) / psnr[h])
        print(f"[suite] test {path}: CopyLastFrame against its recomputation from the same "
              f"{TEST_BATCHES} batches (mse and psnr in f64 on the host, every measure by a new "
              f"provider on the card): largest relative difference {worst:.3g}")
        check(worst <= COPY_RTOL, f"{path}: CopyLastFrame's results differ from their "
              f"recomputation by {worst:.3g}")
        if first_pair is None:
            first_pair = tuple(torch.cat([pairs[i][j] for i in (0, 2)]) for j in (0, 1))
            lpips, fvd, ssim = (METRIC_CLASSES[k]() for k in ("lpips", "fvd", "ssim"))
            pred, target = pairs[0]
            for name, fn in (("LPIPS per_frame", lambda: lpips.per_frame(pred, target)),
                             ("FVD at 10 frames (I3D twice)", lambda: float(fvd(pred, target))),
                             ("SSIM per_frame", lambda: ssim.per_frame(pred, target))):
                fn()
                profile(f"test metrics of one batch ({path}, b=1, {PRED} frames): {name}", fn)

    # every measure on the card against the CPU, on b=2 of the per-step model's
    # (pred, target) pairs, in f32, with PyTorch's default TF32 flags
    pred, target = first_pair
    check(pred.dtype == torch.float32 and tuple(pred.shape) == (2, PRED, IMG[1], IMG[2], IMG[0]),
          f"test predictions are {pred.dtype} {tuple(pred.shape)}")
    def display_err(name, want):
        measure = METRIC_CLASSES[name]()
        got = float(measure.to_display(float(measure(pred, target))))
        return abs(got - want) / abs(want)

    wants = {name: float(cls.to_display(float(cls()(pred.cpu(), target.cpu()))))
             for name, cls in METRIC_CLASSES.items()}
    errs = {name: display_err(name, want) for name, want in wants.items()}
    print("[suite] the measures on the card against the CPU (relative, of the display values), "
          "b=2 of the test's predictions, TF32 flags at PyTorch's defaults: "
          + ", ".join(f"{k} {v:.3g} (limit {MEASURE_RTOL[k]:g})" for k, v in errs.items()))
    check(all(v <= MEASURE_RTOL[k] for k, v in errs.items()),
          "a measure on the card disagrees with the CPU")
    # what the check would see if TF32 reached the measures' convolutions: their
    # guard made a no-op for LPIPS and FVD
    from vp_suite_tpu_torch.measure import image_wise, lpips_net
    from vp_suite_tpu_torch.measure.fvd import fvd, i3d
    guarded = (image_wise, lpips_net, fvd, i3d)
    guards = [m.full_precision for m in guarded]
    for m in guarded:
        m.full_precision = contextlib.nullcontext
    try:
        leaks = {name: display_err(name, wants[name]) for name in ("lpips", "fvd")}
    finally:
        for m, guard in zip(guarded, guards):
            m.full_precision = guard
    print("[suite] the same with TF32 in the measures' cuDNN convolutions (their guard off, "
          "for reference): " + ", ".join(f"{k} {v:.3g}" for k, v in leaks.items()))
    cudnn.allow_tf32, matmul.allow_tf32 = smoke_flags
    SETTINGS._run_path = smoke_run_path
    shutil.rmtree(out_root, ignore_errors=True)
    print(f"[suite] the test phase took {time.time() - t_phase:.1f} s")

#: the file-backed phase (``drive_file_datasets``): its datasets are written
#: under ``vp-suite-data/chip_smoke/data`` in each loader's own format.
#: KTH at its own shape: 6 classes x (20 training + 2 test persons), one
#: video of 40 64x64 frames each (96 sequences train, 24 validate); a third of
#: the videos grey PNGs, the rest RGB.
KTH_PERSONS = (20, 2)
KTH_FRAMES = 40
#: BAIR: 256 training and 16 test sequences of 30 64x64 RGB frames, 4-d actions
#: (245 train, 11 validate).
BAIR_SEQS = (256, 16)
#: KITTI raw: 3 drives of 30 frames at 375x1242 (one drive per split), read at
#: PredNet's 128x160.
KITTI_DRIVES, KITTI_FRAMES, KITTI_IMG = 3, 30, (128, 160)
#: PNG filter types the smoke's encoder cycles through, row by row
PNG_FILTERS = 5
#: epochs of each KTH and BAIR run, with the cache and without (the last one's
#: frames/s is reported: the first of a run also stages the cache)
FILE_EPOCHS = 2


def encode_png(pixels):
    r"""A PNG file's bytes for ``[h, w]`` (grey) or ``[h, w, 3]`` (RGB) uint8
    pixels: row y filtered with type y mod 5 (None, Sub, Up, Average, Paeth),
    so that a reader must undo every filter, one IDAT chunk."""
    import struct
    import zlib
    import numpy as np
    grey = pixels.ndim == 2
    h, w = pixels.shape[:2]
    c = 1 if grey else pixels.shape[2]
    x = pixels.reshape(h, w * c).astype(np.int16)
    a, b, ul = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, c:], b[1:], ul[1:, c:] = x[:, :-c], x[:-1], x[:-1, :-c]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    kinds = np.arange(h) % PNG_FILTERS
    rows = ((x - preds[kinds, np.arange(h)]) % 256).astype(np.uint8)
    body = np.concatenate([kinds[:, None].astype(np.uint8), rows], axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, 0 if grey else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(body, 1)) + chunk(b"IEND", b""))


def _moving_pattern(rng, frames, h, w, grey):
    r"""``frames`` frames of a random coarse pattern (8x8 cells) drifting by a
    few pixels a frame, with a little noise: uint8 ``[t, h, w(, 3)]``."""
    import numpy as np
    cell = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 1 if grey else 3)).astype(np.uint8)
    base = np.kron(cell, np.ones((8, 8, 1), np.uint8))
    dy, dx = rng.integers(-3, 4, 2)
    out = np.stack([np.roll(base, (t * dy, t * dx), axis=(0, 1))[:h, :w] for t in range(frames)])
    out = np.clip(out.astype(np.int16) + rng.integers(-8, 9, out.shape), 0, 255).astype(np.uint8)
    return out[..., 0] if grey else out


def write_file_datasets(root):
    r"""Writes the KTH, BAIR and KITTI trees under ``root``; returns
    ``{path: pixels}`` of a sample of the PNGs written (each KTH video's first
    and last frames, each KITTI drive's first), and the seconds each took."""
    import numpy as np
    from vp_suite_tpu_torch.datasets.kth import KTHActionsDataset, build_kth_metadata
    rng = np.random.default_rng(SEED + 19)
    sample, seconds = {}, {}
    t0 = time.time()
    processed = root / "kth" / "processed"
    for ci, c in enumerate(KTHActionsDataset.CLASSES):
        persons = list(range(1, KTH_PERSONS[0] + 1)) + list(range(21, 21 + KTH_PERSONS[1]))
        for person in persons:
            vid_dir = processed / c / f"person{person:02d}_{c}_d1"
            vid_dir.mkdir(parents=True)
            video = _moving_pattern(rng, KTH_FRAMES, 64, 64, grey=(person + ci) % 3 == 0)
            for f, frame in enumerate(video):
                fp = vid_dir / f"image-{f + 1:03d}_64x64.png"
                fp.write_bytes(encode_png(frame))
                if f in (0, KTH_FRAMES - 1):
                    sample[fp] = frame
    build_kth_metadata(processed, KTHActionsDataset.CLASSES)
    seconds["KTH"] = time.time() - t0

    t0 = time.time()
    for split, n in zip(("train", "test"), BAIR_SEQS):
        d = root / "bair" / "softmotion30_44k" / split
        d.mkdir(parents=True)
        for i in range(n):
            np.save(d / f"seq_{i:05d}_obs.npy", _moving_pattern(rng, 30, 64, 64, grey=False))
            np.save(d / f"seq_{i:05d}_actions.npy", rng.standard_normal((30, 4)).astype(np.float32))
    seconds["BAIR"] = time.time() - t0

    t0 = time.time()
    for drive in range(KITTI_DRIVES):
        d = (root / "kitti" / "2011_09_26" / f"2011_09_26_drive_{drive + 1:04d}_sync"
             / "image_02" / "data")
        d.mkdir(parents=True)
        video = _moving_pattern(rng, KITTI_FRAMES, 375, 1242, grey=False)
        for f, frame in enumerate(video):
            fp = d / f"{f:010d}.png"
            fp.write_bytes(encode_png(frame))
            if f == 0:
                sample[fp] = frame
    seconds["KITTI"] = time.time() - t0
    return sample, seconds


def drive_file_datasets(dev):
    r"""The file-backed data layer on the card: writes KTH, BAIR and KITTI
    trees in their loaders' formats (PNGs by :func:`encode_png`), reads a
    sample of the PNGs back bit for bit; ``load_dataset("KTH")`` ->
    ``create_model("convlstm-shi")`` (bf16, full width) -> ``train`` (b=32,
    5 -> 10) for one epoch through the device-memory cache (``hbm_cache="on"``)
    and one through the host loader (``"off"``), with K1/K2 counts held
    exactly, and one epoch's cached batches against the host loader's on the
    card; the same on BAIR on the fused path (K3s/K4), then ``test`` of its
    checkpoint (K3); KITTI items at 128x160; one epoch of MMF's native
    backend beside the numpy and device backends. Deletes what it wrote."""
    import concurrent.futures as cf
    import shutil
    import numpy as np
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.datasets import KITTIRawDataset, MovingMNISTOnTheFly
    from vp_suite_tpu_torch.defaults import SETTINGS
    from vp_suite_tpu_torch.training.data import BatchLoader, HBMCachedLoader, device_prefetch
    from vp_suite_tpu_torch.utils.image_io import read_png
    t_phase = time.time()
    root = ROOT / "vp-suite-data" / "chip_smoke"
    shutil.rmtree(root, ignore_errors=True)
    data = root / "data"
    sample, seconds = write_file_datasets(data)
    print("[files] wrote KTH (" + f"{6 * sum(KTH_PERSONS) * KTH_FRAMES} PNGs of 64x64), BAIR ("
          f"{sum(BAIR_SEQS)} sequences), KITTI ({KITTI_DRIVES * KITTI_FRAMES} PNGs of 375x1242) "
          f"in " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))

    # the decoder: every filter type, grey and RGB, bit for bit
    for fp, pixels in sample.items():
        got = read_png(fp)
        check(got.dtype == np.uint8 and np.array_equal(got, pixels),
              f"read_png({fp}) is not the encoded pixels")
        rgb = read_png(fp, color=True)
        check(np.array_equal(rgb, np.repeat(pixels[..., None], 3, -1) if pixels.ndim == 2
                             else pixels), f"read_png({fp}, color=True) is not the pixels in RGB")
    print(f"[files] read_png: {len(sample)} PNGs (grey and RGB, rows filtered with all "
          f"{PNG_FILTERS} types) equal the encoded pixels bit for bit")

    smoke_run_path = SETTINGS._run_path
    run_kw = dict(batch_size=B, context_frames=CTX, pred_frames=PRED, no_vis=True,
                  no_wandb=True, epochs=FILE_EPOCHS)
    runs = {}
    for name, dataset_id, path in (("KTH", "KTH", "per_step"), ("BAIR", "BAIR", "fused_scan")):
        suite = VPSuite()
        wrapper = suite.load_dataset(dataset_id, data_dir=str(data / name.lower()),
                                     img_size=IMG[1])
        entry = suite.create_model(PATHS[path][0], compute_dtype=torch.bfloat16, seed=SEED,
                                   **PATHS[path][1])
        check(entry.model.img_shape == IMG, f"{name}: the model took img_shape "
              f"{entry.model.img_shape} from the dataset, not {IMG}")
        steps = len(wrapper.train_data) // B
        fps = {}
        for cache in ("on", "off"):
            out = root / "runs" / f"{name}_{cache}"
            torch.cuda.synchronize()
            counters = reset_counts()
            suite.train(hbm_cache=cache, out_dir=str(out), **run_kw)
            torch.cuda.synchronize()
            launches = read_counts(counters)
            want = want_suite_launches(path, FILE_EPOCHS, steps)
            print(f"[files] train {name} hbm_cache={cache!r}, {FILE_EPOCHS} epochs of {steps} "
                  f"steps: kernel "
                  "launches " + ", ".join(f"{k} {v}" for k, v in launches.items()))
            check(launches == want, f"{name} hbm_cache={cache!r}: train launched {launches}, "
                  f"not {want}")
            with open(out / "metrics.jsonl") as f:
                val = [json.loads(line)["mse"] for line in f]
            check(len(val) == FILE_EPOCHS and all(map(math.isfinite, val)),
                  f"{name}: validation losses {val}")
            fps[cache] = entry.train_epoch_fps[-1]
            runs.setdefault(name, out)
        print(f"[files] train {name} ({path}) bf16 b={B} {CTX}->{PRED} at {IMG[1]}x{IMG[2]}, "
              f"{len(wrapper.train_data)} training sequences: frames/s of the last epoch "
              f"{fps['on']:.1f} through the device-memory cache, {fps['off']:.1f} through the "
              f"host loader ({fps['on'] / fps['off']:.2f}x)")

        # one epoch's cached batches against the host loader's, on the card
        train_data = wrapper.train_data
        cache = HBMCachedLoader(train_data, B, suite.device)
        order = cache.epoch_order(SEED + 1)
        host = device_prefetch((BatchLoader(train_data, B, uint8_frames=True)._stack(
            [train_data[int(i)] for i in order[s:s + B]]) for s in range(0, steps * B, B)),
            suite.device)
        n = 0
        for got, want in zip(cache.epoch_iterator(SEED + 1), host):
            check(got["frames"].device == suite.device and got["frames"].dtype == torch.uint8,
                  f"{name}: a cached batch is {got['frames'].dtype} on {got['frames'].device}")
            check(torch.equal(got["frames"].float() / 255.0, want["frames"].float() / 255.0)
                  and torch.equal(got["actions"], want["actions"]),
                  f"{name}: cached batch {n} is not the host loader's")
            n += 1
        check(n == steps, f"{name}: {n} cached batches, not {steps}")
        print(f"[files] {name}: the {n} cached batches of an epoch equal the host loader's "
              f"batches of the same sequences on the card, bit for bit after dequantisation "
              f"({cache.nbytes / 2**20:.1f} MB staged)")
        del cache

    # test of BAIR's fused checkpoint: K3 for each of the 10 batches
    suite = VPSuite()
    entry = suite.load_model(str(runs["BAIR"]), "best_model")
    suite.load_dataset("BAIR", split="test", data_dir=str(data / "bair"), img_size=IMG[1])
    SETTINGS._run_path = root / "test_runs"
    try:
        torch.cuda.synchronize()
        counters = reset_counts()
        t0 = time.perf_counter()
        (results,) = suite.test(brief_test=True, context_frames=CTX, pred_frames=PRED,
                                metrics="all", no_vis=True, no_wandb=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
    finally:
        SETTINGS._run_path = smoke_run_path
    print(f"[files] test BAIR (fused) brief: kernel launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()) + f"; {wall:.2f} s")
    check(launches == WANT_TEST_LAUNCHES["fused_scan"],
          f"BAIR test launched {launches}, not {WANT_TEST_LAUNCHES['fused_scan']}")
    check(list(results) == [entry.NAME, "CopyLastFrame"] and all(
        len(h) == PRED and all(math.isfinite(v) for d in h for v in d.values())
        for h in results.values()), f"BAIR test results {results}")
    print(f"[files] test BAIR: {entry.NAME} at horizon {PRED}: "
          + ", ".join(f"{k.split()[0]} {v:.4g}" for k, v in results[entry.NAME][-1].items()))

    # KITTI items at PredNet's size
    kitti = KITTIRawDataset("train", data_dir=str(data / "kitti"), img_size=KITTI_IMG)
    kitti.set_seq_len(CTX, PRED, 1)
    t0 = time.perf_counter()
    items = [kitti[i] for i in range(len(kitti))]
    per_item = (time.perf_counter() - t0) / len(items) * 1e3
    for it in items:
        f = it["frames"]
        check(f.shape == (CTX + PRED, *KITTI_IMG, 3) and f.dtype == np.float32
              and np.isfinite(f).all() and 0.0 <= f.min() and f.max() <= 1.0,
              f"KITTI item frames {f.shape} {f.dtype} in [{f.min()}, {f.max()}]")
    print(f"[files] KITTI: {len(items)} items of {CTX + PRED} 375x1242 PNGs resized to "
          f"{KITTI_IMG[0]}x{KITTI_IMG[1]}: {per_item:.1f} ms per item "
          f"({per_item / (CTX + PRED):.2f} ms per frame, one thread)")

    # MMF's native backend: one epoch beside the numpy and device backends
    n_seqs = 4 * B
    rates = {}
    for backend in ("numpy", "native"):
        ds = MovingMNISTOnTheFly("train", img_size=IMG[1], digit_source="synthetic",
                                 backend=backend, n_seqs=n_seqs)
        ds.set_seq_len(CTX, PRED, 1)
        t0 = time.perf_counter()
        n = sum(b["frames"].shape[0] for b in BatchLoader(ds, B, shuffle=True, drop_last=True,
                                                           uint8_frames=True))
        rates[backend] = n * (CTX + PRED) / (time.perf_counter() - t0)
        if backend == "native":
            once, twice = ds[7]["frames"], ds[7]["frames"]
            with cf.ThreadPoolExecutor(max_workers=2) as pool:
                a, b = pool.map(lambda i: ds[i]["frames"], (7, 7))
            check(np.array_equal(once, twice) and np.array_equal(a, once)
                  and np.array_equal(b, once) and once.max() > 0.1,
                  "native MMF item 7 differs between reads or threads")
    ds = MovingMNISTOnTheFly("train", img_size=IMG[1], digit_source="synthetic",
                             backend="device", n_seqs=n_seqs)
    ds.set_seq_len(CTX, PRED, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(b["frames"].shape[0] for b in ds.device_batch_iterator(B, n_seqs // B, SEED, dev))
    torch.cuda.synchronize()
    rates["device"] = n * (CTX + PRED) / (time.perf_counter() - t0)
    print(f"[files] MMF one epoch of {n_seqs} sequences ({CTX + PRED} 64x64 frames, b={B}): "
          + ", ".join(f"{k} {v:.1f} frames/s" for k, v in rates.items())
          + " (numpy and native: BatchLoader's 4 threads and uint8 stacking; device: the card's "
          "generator); native item 7 the same read twice and from two threads")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[files] the file-backed phase took {time.time() - t_phase:.1f} s")

#: the models that reach no port kernel, at bench width: name -> (registry id,
#: configuration). UNet-3D and PredRNN++ (slice 14), PhyDNet (slice 15, its
#: defaults: one 7x7 PhyCell of 49 channels, ConvLSTM (128, 128, 64), DCGAN
#: widths 32/64), and MinConvRNN (2 layers of 64 channels at
#: 16x16), SimVP (hid_s 64, hid_t 256, 4 blocks, ``in_frames=5`` as
#: ``bench.py`` sets it) and PredFormer (8x8 patches, dim 256, depth 4, 4
#: heads), ST-Phy (3 layers of 64-channel ST-LSTM cells and 7x7 PhyCells of
#: 49 on 12x12 codes) and the encoder-LSTM-decoder (a 1024 bottleneck, 3 LSTM
#: layers of 1024) at their defaults; their convolutions and matmuls go to
#: cuDNN and cuBLAS, as the JAX package leaves them to XLA.
NEW_MODELS = {"unet3d": ("unet-3d", dict(temporal_dim=3, features=(8, 16, 32, 64))),
              "predrnn": ("predrnn-pp", {}),
              "phydnet": ("phy", {}),
              "min_conv_rnn": ("min-conv-rnn", {}),
              "simvp": ("simvp", dict(in_frames=5)),
              "pred_former": ("pred-former", {}),
              "st_phy": ("st-phy", {}),
              "lstm": ("lstm", {})}
#: the new models that take actions: their f32 ``predict`` with
#: ``action_conditional=True`` and 3 action channels, card against CPU at b=2
NEW_ACTIONS = ("st_phy", "lstm")


def no_gradient(name, model):
    r"""The parameters of new model ``name`` that no output or loss of a train
    step reads, so that they get no gradient: ST-Phy's layers all read the
    step's code and each layer's hidden conv replaces the latent of the one
    before it (as in the JAX model), so the PhyCells and hidden convs below
    the last layer feed nothing but the first PhyCell's F conv weight, which
    the moment loss reads."""
    if name != "st_phy":
        return set()
    top = model.num_layers - 1
    return {k for k, _ in model.named_parameters()
            if k.startswith(("phycell_list.", "hidden_conv_list."))
            and not k.startswith((f"phycell_list.{top}.", f"hidden_conv_list.{top}."))
            and k != "phycell_list.0.F.conv1.weight"}


#: the new models whose bf16 ``predict`` on the card is also held against the
#: CPU's f32 one at b=2, within ``PREDICT_ATOL_BF16`` times the largest |f32
#: prediction| where that exceeds 1 (bf16 rounds relative to the values, and
#: SimVP's and PredFormer's random-weight predictions leave [0, 1]): PhyDNet's
#: GroupNorms reduce bf16 activations (cuDNN-free ``F.group_norm``, f32
#: statistics, one rounding); MinConvRNN's gates, ``1 - f`` and recurrence run
#: in bf16; SimVP's GroupNorms; PredFormer's softmax in bf16, its LayerNorms'
#: f32 statistics; ST-Phy's LayerNorms over its bf16 gate convs (f32
#: statistics) and its bf16 cells; LSTM's bf16 cells and its 16,384-long bf16
#: products (cuBLAS accumulates them in f32 and rounds once).
NEW_BF16_PREDICT = ("phydnet", "min_conv_rnn", "simvp", "pred_former", "st_phy", "lstm")
#: the new models whose SGD step gate runs with f64 activations on both sides
#: (``compute_dtype=torch.float64``, f32 parameters): PhyDNet's f32 gradient at
#: b=2 is ill-conditioned (GroupNorms over near-constant groups at the zero
#: initial states, group variances down to 3.7e-5, beside LeakyReLU inputs
#: within rounding of 0, whose slope f32 rounding picks), so that two f32 runs
#: part by 1e-2 of the largest (p0 - p1) / lr: on an H100's machine the CPU's
#: f32 from its f64 by 1.17e-2, the card's f32 by 2.34e-3 (``python3 -m
#: vp_suite_tpu_torch.kernels.phydnet_variants`` prints both). Their f32 steps
#: are each held against the CPU's f64 one instead: the card's no further from
#: it than twice the CPU's own (or ``NEW_STEP_REL``).
NEW_STEP_F64 = ("phydnet",)
#: the new models whose step also runs on the CPU with f64 activations and in
#: f32 on one thread, and whose f32 steps' distances from each other and from
#: f64 are printed: the witness of their conditioning. ST-Phy's f32 steps lie
#: 2.7e-4 and 3.3e-4 (CPU, card) of the largest from f64, but its f32 runs
#: part by only 1.3e-5 (the CPU on one thread and on eight) and 6.2e-5 (the
#: card and the CPU) on an H100's machine, so its gate is the direct one.
NEW_STEP_WITNESS = NEW_STEP_F64 + ("st_phy",)
#: steps of each new model's facade run (one epoch on the card's batches)
NEW_SUITE_STEPS = 2
#: UNet-3D's BatchNorm running statistics after one f32 SGD step, card against
#: CPU: means and variances of the same f32 values summed in another order.
STATS_ATOL = 1e-5
#: the f32 SGD step of the new models, card against CPU, as (p0 - p1) / lr,
#: relative to the largest of each tensor (absolute below 1): the summed MSE
#: gives gradients of order 100, whose f32 sums in another order leave errors
#: of order 1e-3 on their small elements; a conv bias before a BatchNorm has a
#: gradient of 0 that both sides compute as f32 noise.
NEW_STEP_REL = STEP_TOL
#: frames predicted in that step, where not PRED: UNet-3D's rollout in train
#: mode feeds each prediction back through BatchNorms that normalize by the
#: batch's own statistics, which amplifies f32 rounding step by step, so that
#: at 5 -> 10 two f32 runs part by some 2.5-13 of the largest (p0 - p1) / lr,
#: the CPU against itself at another thread count or against f64 as much as
#: the card against the CPU (``python3 -m
#: vp_suite_tpu_torch.kernels.unet3d_variants`` prints them), while at 5 -> 1
#: every pair holds 5e-4; its eval-mode predict holds over 10. The same
#: rounding makes its bf16 Adam run at 5 -> 10 a random walk of a few units on
#: a loss of 3922 (its card backward is not bit-reproducible, with cuDNN's
#: deterministic algorithms too; ``unet3d_variants --descent`` prints runs),
#: so its loss is held to fall at 5 -> 1, where 7 steps take it down by some
#: 315, every step.
NEW_STEP_PRED = {"unet3d": 1}


def _worst_step_diff(got, want):
    r"""``(rel, name)``: the largest ``max |got - want| / max(max |want|, 1)``
    over the parameters' (p0 - p1) / lr."""
    worst, worst_name = 0.0, ""
    for k, w in want.items():
        rel = (got[k] - w).abs().max().item() / max(w.abs().max().item(), 1.0)
        if rel > worst or not worst_name:
            worst, worst_name = rel, k
    return worst, worst_name


def _new_model(suite, name, **kw):
    model_id, cfg = NEW_MODELS[name]
    return suite.create_model(model_id, **{"img_shape": IMG, "action_size": 0,
                                           "tensor_value_range": (0.0, 1.0), "seed": SEED,
                                           **cfg, **kw})


def _median_ms(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] * 1e3, times


def _time_step(step, state, batch, n=5, warmup=2):
    r"""Median host time of ``n`` train steps after ``warmup``, each ended by
    a read of the loss; returns (ms, losses, times)."""
    losses = []

    def one():
        losses.append(float(step(state, batch)[1]["total"]))   # waits for the card
    for _ in range(warmup):
        one()
    ms, times = _median_ms(one, n)
    return ms, losses, times


def _zero_launches(name, what, counters):
    import torch
    torch.cuda.synchronize()
    launches = read_counts(counters)
    print(f"[{name}] kernel launches in {what}: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(launches == _launches(), f"{name}: {what} launched port kernels: {launches}")


def _adam_losses(name, batch, run_config, steps=7):
    r"""The losses of ``steps`` Adam steps of a new bf16 model on ``batch``,
    every launch count held at 0."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    model = _new_model(VPSuite(), name, compute_dtype=torch.bfloat16).model
    state = create_train_state(model, lr=LR, seed=SEED)
    step = make_train_step(model, run_config)
    counters = reset_counts()
    losses = [float(step(state, batch)[1]["total"]) for _ in range(steps)]
    _zero_launches(name, f"{steps} train steps", counters)
    return losses


def _time_new_model(name, frames, batch, run_config):
    r"""One new model at bench width in bf16: ``predict`` and the Adam train
    step, each launch count held at 0 (the compiled predictor's and an eager
    step's), their compiled latencies and profiles (``VPSuite.predict`` and
    the default step: CUDA-graph replays), the peak memory of the eager
    step, the loss falling at each of 7 steps (the eager one and six of the
    compiled step; UNet-3D's at 5 -> 1, ``NEW_STEP_PRED``) and the schedule
    after them; returns ``{"graph_predict_ms", "graph_step_ms",
    "profiles"}`` (``profiles[what]`` the ``(device ms, host ms)`` of one
    profiled replay)."""
    import numpy as np
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    suite = VPSuite()
    model = _new_model(suite, name, compute_dtype=torch.bfloat16).model
    counters = reset_counts()
    preds = suite.predict(frames[:, :CTX], pred_frames=PRED)
    _zero_launches(name, "one predict", counters)
    check(tuple(preds.shape) == (B, PRED, IMG[1], IMG[2], IMG[0])
          and preds.dtype == torch.float32 and bool(torch.isfinite(preds).all()),
          f"{name}: predict gave {tuple(preds.shape)} {preds.dtype}, or non-finite values")
    profiles = {}

    def predict():
        suite.predict(frames[:, :CTX], pred_frames=PRED)
    predict()    # the capture
    graph_pred_ms, times = _median_ms(lambda: (predict(), torch.cuda.synchronize()), 3)
    print(f"[time] predict {name} bf16 b={B} {CTX}->{PRED} at 64x64, graphed: median "
          f"{graph_pred_ms:.2f} ms (runs {', '.join(f'{t * 1e3:.2f}' for t in times)}), "
          f"{B * PRED / graph_pred_ms * 1e3:.0f} frames/s")
    profiles["predict"] = profile(f"predict {name} graphed", predict)

    state = create_train_state(model, lr=LR, seed=SEED)
    step = make_train_step(model, run_config, use_jit=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    counters = reset_counts()
    _, metrics = step(state, batch)
    _zero_launches(name, "one train step", counters)
    peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
    losses = [float(metrics["total"])]
    unread = no_gradient(name, model)
    for pname, p in model.named_parameters():
        if pname in unread:
            check(p.grad is None, f"{name}: parameter {pname}, which nothing reads, has a gradient")
            continue
        check(p.grad is not None and p.grad.dtype == torch.float32
              and bool(torch.isfinite(p.grad).all()),
              f"{name}: parameter {pname} has no finite f32 gradient after a step")
    graphed = make_train_step(model, run_config)
    graph_step_ms, more, times = _time_step(graphed, state, batch, n=4, warmup=2)
    losses += more
    check(all(map(math.isfinite, losses)), f"{name}: non-finite training loss {losses}")
    falling, fall_of = losses, f"{CTX}->{PRED}"
    if name in NEW_STEP_PRED:
        fall_of = f"{CTX}->{NEW_STEP_PRED[name]}"
        falling = _adam_losses(name, {"frames": batch["frames"][:, :CTX + NEW_STEP_PRED[name]]},
                               {**run_config, "pred_frames": NEW_STEP_PRED[name]})
        print(f"[train] {name} bf16 b={B} {fall_of}, Adam lr {LR}: losses "
              + ", ".join(f"{x:.2f}" for x in falling))
    check(all(map(math.isfinite, falling)) and all(b < a for a, b in zip(falling, falling[1:])),
          f"{name}: the loss did not fall at each of 7 Adam steps ({fall_of}): {falling}")
    want_state = model.init_model_state()
    if want_state:     # 7 steps, two mask draws a step (reverse_input), f32 decays
        eta = np.float32(want_state["sampling_eta"])
        for _ in range(2 * 7):
            eta = np.float32(eta - np.float32(model.sampling_changing_rate))
        want_state = {"training_iteration": 8, "sampling_eta": float(eta)}
    check(state.step == 7 and state.model_state == want_state,
          f"{name}: after 7 steps the state counts {state.step} steps and holds "
          f"{state.model_state}, not {want_state}")
    print(f"[train] {name} bf16 b={B} {CTX}->{PRED} at 64x64, Adam lr {LR}: losses "
          + ", ".join(f"{x:.2f}" for x in losses)
          + f" (an eager step, then the compiled step's eager call, capture and 4 replays); "
          f"graphed median step {graph_step_ms:.2f} ms (replays "
          + ", ".join(f"{t * 1e3:.2f}" for t in times) + ")"
          f", {B * (CTX + PRED) / graph_step_ms * 1e3:.0f} frames/s; peak memory of the eager "
          f"step {peak:.2f} GiB above what was live before; model_state {state.model_state}")
    profiles["train step"] = profile(f"train step {name} graphed",
                                     lambda: float(graphed(state, batch)[1]["total"]))
    return dict(graph_predict_ms=graph_pred_ms, graph_step_ms=graph_step_ms, profiles=profiles)


#: the kernels' names in a profiler trace, by launch-count id (K3 and K3s are one kernel)
#: on the model paths
KERNEL_NAMES = {"K1": "_convlstm_gate_fwd", "K2": "_convlstm_gate_bwd", "K3": "scan_fwd_",
                "K3s": "scan_fwd_", "K4": "scan_bwd_", "warp_fwd": "warp_fwd_kernel",
                "warp_bwd": "warp_bwd_kernel", "E1": "sym_eig_kernel"}
#: the graphed-against-eager gates: f32 steps at b=2 on one batch, the learning
#: rate cut by ReduceLROnPlateau before the last (after the capture)
GRAPH_STEPS = 4
GRAPH_LR = 1e-4
#: PhyDNet's epochs in the coin check: its teacher-forcing ratio is 1 at epoch 0
#: (the eager step's and the capture's), 0.499 at 167 and 0 from 334 on
GRAPH_COIN_EPOCHS = (0, 0, 0, 167, 167, 167, 167, 334)
#: PredRNN++'s steps in the mask check, from ``sampling_stop_iter - 3`` (a rate of
#: 0.5): its fourth step draws at the stop, where the rate falls to 0
GRAPH_MASK_STEPS = 6


def by_name(launches):
    r"""Launch counts by kernel id summed by :data:`KERNEL_NAMES`' names."""
    out = dict.fromkeys(KERNEL_NAMES.values(), 0)
    for k, name in KERNEL_NAMES.items():
        out[name] += launches[k]
    return out


def replay_launches(fn, want, tries=3):
    r"""The launches of the port's kernels in one call of ``fn`` as the
    profiler saw them on the card, by :data:`KERNEL_NAMES`' names: the most
    of each over up to ``tries`` profiled calls, until they equal ``want``.
    CUPTI can drop records of a call of thousands of launches (the profile of
    one EF-TrajGRU train step replay on an H100 held 39 of its 45 warp
    forwards); it adds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    seen = dict.fromkeys(KERNEL_NAMES.values(), 0)
    for _ in range(tries):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = {name: max(n, sum(e.count for e in kernels if name in e.key))
                for name, n in seen.items()}
        if seen == want:
            break
    return seen


def drive_graphs(card, new_times):
    r"""The compiled step (``use_jit=True``: CUDA-graph capture) on paths
    (a)-(c) at full width: for ``predict`` and the Adam train step in bf16 at
    b=32, the launch counts of the eager first call and of the capture
    (each as one call launches), none from the host in a replay, the
    profiler's kernel counts over one replay (the same), and eager against
    graphed latency, device time and busy share; in f32 at b=2 under cuDNN's
    deterministic algorithms, the graphed SGD and Adam steps against the
    eager ones: each step's loss within 1e-5 relative, the parameters after 3
    steps and after a 4th that follows a ReduceLROnPlateau cut as ``(p0 -
    p1) / lr`` within the SGD gate (Adam's only where two eager SGD runs agree
    bit for bit: path (c)'s warp backward sums by float atomics, and Adam
    divides each gradient by its running size, so its ulps in gradients near 0
    move whole updates; printed beside a second eager run there), and
    ``predict`` (within the f32 gate); at 16x16, PhyDNet's teacher-forcing
    coins and PredRNN++'s sampling masks in each graphed step equal the eager
    step's across the epoch and the iteration where they change; then the
    eager-against-graphed table, with the graphed rows of (h)-(o) from
    ``new_times``."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.schedule import ReduceLROnPlateau, set_learning_rate
    from vp_suite_tpu_torch.training.train_state import create_train_state
    t_phase = time.time()
    run = {"context_frames": CTX, "pred_frames": PRED}
    frames = torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
    batch = {"frames": frames}
    rows = {}
    suite = VPSuite()
    create_models(suite, compute_dtype=torch.bfloat16)
    for i, name in enumerate(PATHS):
        model = suite.models[i].model
        state = create_train_state(model, lr=LR, seed=SEED)
        fns = {"predict": (make_predict_fn(model, run, use_jit=False), make_predict_fn(model, run),
                           WANT_PREDICT_LAUNCHES[name]),
               "train step": (make_train_step(model, run, use_jit=False), make_train_step(model, run),
                              WANT_TRAIN_LAUNCHES[name])}
        for what, (eager, graphed, want) in fns.items():
            def call(fn):
                if what == "predict":
                    fn(batch)
                    torch.cuda.synchronize()
                else:
                    float(fn(state, batch)[1]["total"])   # waits for the card
            counts, host = [], []
            for _ in range(3):     # eager, the capture (and its replay), a replay
                counters = reset_counts()
                t0 = time.perf_counter()
                call(graphed)
                host.append((time.perf_counter() - t0) * 1e3)
                counts.append(read_counts(counters))
            seen = replay_launches(lambda: call(graphed), by_name(want))
            print(f"[graphs] {name} {what}: launches counted in the eager call "
                  + ", ".join(f"{k} {v}" for k, v in counts[0].items() if v)
                  + ", in the capture " + ", ".join(f"{k} {v}" for k, v in counts[1].items() if v)
                  + f", from the host in a replay {sum(counts[2].values())}; the profiler's "
                  f"kernels in one replay " + ", ".join(f"{k} {v}" for k, v in seen.items() if v)
                  + f"; host ms of the eager call, the capture with its replay, and a replay: "
                  + " / ".join(f"{t:.2f}" for t in host))
            check(counts[0] == want and counts[1] == want and counts[2] == _launches(),
                  f"{name} {what}: the eager call, the capture and a replay launched {counts}, "
                  f"not {want}, {want} and none")
            check(seen == by_name(want),
                  f"{name} {what}: the profiler saw {seen} in one replay, not {by_name(want)}")
            for how, fn in (("eager", eager), ("graphed", graphed)):
                call(fn)
                ms, times = _median_ms(lambda: call(fn), 3)
                dev_ms, wall = profile(f"{what} {name} {how}", lambda: call(fn),
                                       pick=("warp_fwd_kernel", "warp_bwd_kernel")
                                       if name == "trajgru" else ())
                rows[(name, what, how)] = (ms, dev_ms, wall)
                print(f"[graphs] {what} {name} bf16 b={B} {CTX}->{PRED} at 64x64, {how}: median "
                      f"{ms:.2f} ms (runs {', '.join(f'{t * 1e3:.2f}' for t in times)})")
        del model, state, fns
    del suite
    torch.cuda.empty_cache()

    # graphed against eager in f32 at b=2, deterministic
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    small = {"frames": frames[:2]}
    reproducible = {}
    for optimizer in ("sgd", "adam"):
        # eager, graphed and a second eager run, on models from one seed
        suites = [VPSuite() for _ in range(3)]
        for s_ in suites:
            create_models(s_, compute_dtype=torch.float32)
        for i, name in enumerate(PATHS):
            models = [s_.models[i].model for s_ in suites]
            p0 = {k: v.detach().clone() for k, v in models[0].named_parameters()}
            states = [create_train_state(m, lr=GRAPH_LR, optimizer=optimizer) for m in models]
            steps = [make_train_step(m, run, use_jit=j == 1) for j, m in enumerate(models)]
            cuts = [ReduceLROnPlateau(GRAPH_LR, patience=0) for _ in states]
            for n in range(1, GRAPH_STEPS + 1):
                if n == GRAPH_STEPS:   # a plateau: the rate falls to a fifth
                    for cut, st in zip(cuts, states):
                        cut.step(1.0)
                        set_learning_rate(st, cut.step(2.0))
                losses = [float(step(st, small)[1]["total"]) for step, st in zip(steps, states)]
                check(abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]),
                      f"{name} {optimizer}: the graphed step {n}'s loss {losses[1]} is not the "
                      f"eager step's {losses[0]}")
                if n < GRAPH_STEPS - 1:
                    continue
                deltas = [{k: (p0[k] - v.detach()) / GRAPH_LR for k, v in m.named_parameters()}
                          for m in models]
                worst = [_delta_excess(deltas[j], deltas[0]) for j in (1, 2)]
                same = [sum(torch.equal(a, b) for a, b in zip(models[0].parameters(),
                                                              models[j].parameters()))
                        for j in (1, 2)]
                if optimizer == "sgd":
                    reproducible[name] = same[1] == len(p0)
                held = optimizer == "sgd" or reproducible[name]
                print(f"[graphs] {name} f32 b=2 {optimizer} step {n}"
                      f"{' (after the cut to ' + str(cuts[0].lr) + ')' if n == GRAPH_STEPS else ''}"
                      f", graphed against eager: loss {losses[1]:.6f} vs {losses[0]:.6f}; "
                      f"{same[0]} of {len(p0)} parameters bit-identical; (p0-p1)/lr max(|diff| - "
                      f"rtol*|eager|) {worst[0][0]:.3g} at {worst[0][1]} "
                      + (f"(rtol {STEP_TOL}, must stay <= atol {STEP_TOL})" if held else
                         "(printed: the eager step is not bit-reproducible on this path, and "
                         "Adam turns its ulps in gradients near 0 into whole updates)")
                      + f"; a second eager run against the first: {same[1]} bit-identical, "
                      f"{worst[1][0]:.3g} at {worst[1][1]}")
                if held:
                    check(worst[0][0] <= STEP_TOL,
                          f"{name} {optimizer}: the graphed step {n} parts from the eager one")
            if optimizer == "sgd":
                want = make_predict_fn(models[1], run, use_jit=False)(small)[0]
                graphed = make_predict_fn(models[1], run)
                got = [graphed(small)[0] for _ in range(3)]
                d = max((g - want).abs().max().item() for g in got)
                print(f"[graphs] {name} f32 b=2 predict, graphed (eager, capture, replay) against "
                      f"eager: max diff {d:.3g} (atol {PREDICT_ATOL_F32})")
                check(d <= PREDICT_ATOL_F32, f"{name}: the graphed predict parts from the eager")
        del suites, models, states, steps
    graph_coins_and_masks()
    torch.backends.cudnn.deterministic = False

    print(f"[graphs] eager against graphed on {card}: host latency (median, ending in a read) "
          f"and one profiled call's device time in its host time (busy share)")
    for (name, what, how), (ms, dev_ms, wall) in rows.items():
        busy = f"{dev_ms:.2f} ms in {wall:.2f} ms ({dev_ms / wall:.0%})" if dev_ms else \
            "not measured"
        print(f"[graphs]   ({name}) {what} {how}: {ms:.2f} ms; device {busy}")
    for name, t in new_times.items():
        for what, key in (("predict", "graph_predict_ms"), ("train step", "graph_step_ms")):
            dev_ms, wall = t["profiles"][what]
            busy = f"{dev_ms:.2f} ms in {wall:.2f} ms ({dev_ms / wall:.0%})" if dev_ms else \
                "not measured"
            print(f"[graphs]   ({name}) {what} graphed: {t[key]:.2f} ms; device {busy}")
    print(f"[graphs] phase {time.time() - t_phase:.1f} s")


def decoder_probe():
    r"""What this machine offers to decode video files (the JAX package reads
    them through ``cv2.VideoCapture``, which the port may not import): the
    ``ffmpeg`` binary, the ``avcodec`` library, and whether ``torchvision``
    and ``torchcodec`` import; one line."""
    import ctypes.util
    import importlib
    import shutil
    found = {"ffmpeg": shutil.which("ffmpeg"), "avcodec": ctypes.util.find_library("avcodec")}
    for name in ("torchvision", "torchcodec"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "imports")
        except Exception as e:      # absent, or present and broken: either way no decoder
            found[name] = f"does not import ({type(e).__name__}: {str(e)[:80]})"
    return "[probe] video decoders: " + "; ".join(f"{k} {v}" for k, v in found.items())


#: drive_remat's paths at bench shapes: (a) per step under each of the cells'
#: policies, (b), (c) and (h)-(o); name -> (registry id, configuration)
REMAT_PATHS = {"per_step": PATHS["per_step"],
               "per_step_full": ("convlstm-shi", dict(remat_policy="full")),
               "fused_scan": PATHS["fused_scan"], "trajgru": PATHS["trajgru"], **NEW_MODELS}
#: replays timed per path and setting
REMAT_REPLAYS = 3


def _remat_model(name, remat_on, dtype, seed=SEED):
    r"""Path ``name``'s model on the card with ``remat`` on or off."""
    from vp_suite_tpu_torch.models import build_model
    model_id, cfg = REMAT_PATHS[name]
    model = build_model(model_id, seed, "cuda", img_shape=IMG, action_size=0,
                        tensor_value_range=(0.0, 1.0), compute_dtype=dtype, **cfg)
    return _set_remat(model, remat_on)


def _set_remat(model, remat_on):
    r"""``model`` with ``remat`` on or off: the model's hyperparameter and every
    block's (EF-ConvLSTM's cells' own: the model's never reaches them, as in
    the JAX package)."""
    for module in model.modules():
        if hasattr(module, "remat"):
            module.remat = remat_on
    return model


def _want_remat_launches(name, remat_on):
    if name in NEW_MODELS:
        return _launches()
    path = "per_step" if name == "per_step_full" else name
    return (WANT_TRAIN_LAUNCHES if remat_on else WANT_TRAIN_LAUNCHES_NO_REMAT)[path]


def drive_remat(card):
    r"""Rematerialisation (``remat``, ``nn.remat``) on and off, at bench
    shapes (b=32, 64x64, 5 -> 10, bf16 over f32, Adam) for paths (a) under the
    cells' ``"gates"`` and ``"full"`` policies, (b), (c) and (h)-(o): the peak
    card memory of one eager train step above what was live before it
    (``max_memory_allocated`` after ``reset_peak_memory_stats``) and that
    step's host time (its builder's first call, after the compiled step's
    eager call warmed the model up; ending in a read of the loss), the launches
    of the eager call and of the capture of the compiled step (each held:
    K1 45 + 45 again on (a) with remat on, 45 off; K2, K3s / K4 and the warp
    as before; none on (h)-(o)), the graphed step's latency (median of
    replays, each ending in a read of the loss); ``predict``'s launches on
    (a)-(c) equal with remat on and off; and in f32 at b=2 under cuDNN's
    deterministic algorithms the SGD step with remat on against off on (a)
    under each policy, (b) and (c) (bit-identical parameters; on (c), whose
    warp backward sums by float atomics, within the SGD gate) and the graphed
    step under ``"full"`` against the eager one (``drive_graphs`` holds the
    default policy's)."""
    import torch
    from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    t_phase = time.time()
    run = {"context_frames": CTX, "pred_frames": PRED}
    frames = torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 7))
    batch = {"frames": frames}
    rows = {}
    for name in REMAT_PATHS:
        model = _remat_model(name, False, torch.bfloat16)
        for remat_on in (False, True):
            _set_remat(model, remat_on)
            state = create_train_state(model, lr=LR, seed=SEED)
            eager = make_train_step(model, run, use_jit=False)
            graphed = make_train_step(model, run)
            launches = []

            def counted(step):
                counters = reset_counts()
                float(step(state, batch)[1]["total"])     # waits for the card
                launches.append(read_counts(counters))
            counted(graphed)         # the compiled step's eager first call (and the warm-up)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            counted(eager)
            eager_ms = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
            counted(graphed)         # the capture
            ms, losses, _ = _time_step(graphed, state, batch, n=REMAT_REPLAYS, warmup=0)
            want = _want_remat_launches(name, remat_on)
            check(launches == [want] * 3,
                  f"{name} remat {remat_on}: the compiled step's eager call, the eager step and "
                  f"the capture launched {launches}, not {want}")
            check(all(map(math.isfinite, losses)), f"{name} remat {remat_on}: losses {losses}")
            rows[(name, remat_on)] = (peak, ms, eager_ms)
            print(f"[remat] {name} remat {'on ' if remat_on else 'off'} bf16 b={B} {CTX}->{PRED} "
                  f"at 64x64: peak memory of an eager train step {peak:.3f} GiB above what was "
                  f"live, its host time {eager_ms:.2f} ms; graphed step {ms:.2f} ms; launches "
                  f"per eager call and per capture "
                  + (", ".join(f"{k} {v}" for k, v in want.items() if v) or "none"))
            del state, eager, graphed
            torch.cuda.empty_cache()
        del model
        (p0, t0, e0), (p1, t1, e1) = rows[(name, False)], rows[(name, True)]
        print(f"[remat] {name}: remat on against off, peak {p1:.3f} / {p0:.3f} GiB "
              f"({p1 / p0 - 1:+.1%}), graphed step {t1:.2f} / {t0:.2f} ms ({t1 / t0 - 1:+.1%}), "
              f"eager step {e1:.2f} / {e0:.2f} ms (one call each) on {card}")

    # predict launches what it launched: remat acts only where a gradient is built
    for name in PATHS:
        got = {}
        for remat_on in (False, True):
            predict = make_predict_fn(_remat_model(name, remat_on, torch.bfloat16), run,
                                      use_jit=False)
            counters = reset_counts()
            predict(batch)
            torch.cuda.synchronize()
            got[remat_on] = read_counts(counters)
        print(f"[remat] {name} predict launches, remat off / on: "
              + ", ".join(f"{k} {got[False][k]} / {got[True][k]}" for k in KERNEL_IDS
                          if got[False][k] or got[True][k]))
        check(got[False] == got[True] == WANT_PREDICT_LAUNCHES[name],
              f"{name}: predict launched {got} with remat off / on")

    # f32 b=2: remat on against off, and the graphed step under "full" against eager
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    small = {"frames": frames[:2]}
    lr = 1e-2
    for name in ("per_step", "per_step_full", "fused_scan", "trajgru"):
        deltas = {}
        for how, remat_on, jit in (("off", False, False), ("on", True, False),
                                   ("on, graphed", True, True)):
            if jit and name != "per_step_full":
                continue
            model = _remat_model(name, remat_on, torch.float32)
            p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
            state = create_train_state(model, lr=lr, optimizer="sgd")
            step = make_train_step(model, run, use_jit=jit)
            for _ in range(3 if jit else 1):   # graphed: the eager call, the capture, a replay
                model.load_state_dict(p0, strict=False)
                loss = float(step(state, small)[1]["total"])
            deltas[how] = (loss, {k: (p0[k] - v.detach()) / lr
                                  for k, v in model.named_parameters()})
        for how in [h for h in deltas if h != "off"]:
            ref = deltas["on" if how == "on, graphed" else "off"]
            same = sum(torch.equal(deltas[how][1][k], v) for k, v in ref[1].items())
            worst, where = _delta_excess(deltas[how][1], ref[1])
            exact = name != "trajgru"
            print(f"[remat] {name} f32 b=2 SGD step, remat {how} against "
                  f"{'eager' if how == 'on, graphed' else 'off'}: loss {deltas[how][0]:.6f} vs "
                  f"{ref[0]:.6f}; {same} of {len(ref[1])} parameters' (p0-p1)/lr bit-identical; "
                  f"max(|diff| - rtol*|ref|) {worst:.3g} at {where} "
                  + ("(must be bit-identical)" if exact else
                     f"(rtol {STEP_TOL}, must stay <= atol {STEP_TOL}: the warp backward sums "
                     f"by float atomics)"))
            if exact:
                check(same == len(ref[1]) and deltas[how][0] == ref[0],
                      f"{name}: the f32 step with remat {how} is not bit-identical")
            else:
                check(worst <= STEP_TOL and abs(deltas[how][0] - ref[0]) <= 1e-5 * abs(ref[0]),
                      f"{name}: the f32 step with remat {how} parts from the reference")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    print(f"[remat] phase {time.time() - t_phase:.1f} s")


#: the FVD loss (``drive_fvd_loss``): E1's sizes against ``torch.linalg.eigh``, FVD
#: batches (b=1 the zero matrix; A and V in shared memory up to about 168, in the
#: scratch above)
E1_SIZES = (1, 2, 4, 10, 32, 128, 160, 256)
#: E1's eigenvalues within this of the largest, against ``torch.linalg.eigh`` in f64 on
#: the CPU; the reconstruction ``v diag(w) v^T`` (of the largest eigenvalue) and ``v^T v -
#: I`` likewise: an f32 solver's rounding, well below the limit up to b = 256. The card's f32
#: ``torch.linalg.eigh`` (cuSOLVER) is printed beside it: its eigenvalues part from f64 by
#: 2.8e-5 of the largest at b = 128 (while E1's reconstruction holds to 2e-7), so it is not
#: the reference
E1_TOL = 1e-5
FVD_LOSSES = {"mse": 1.0, "fvd": 1.0}
#: ``wasserstein2_torch`` on the card (E1, cuBLAS) against the CPU (LAPACK) on
#: independent 400-wide features at b=32, value relative and gradient relative to its
#: largest: f32 sums in another order, where the covariance part is well determined
W2_RTOL = 1e-4
#: each train or eval call with an FVD loss of 10 predicted frames (one I3D chunk)
#: launches E1 once, beside the path's kernels
WANT_FVD_TRAIN_LAUNCHES = {path: {**WANT_TRAIN_LAUNCHES[path], "E1": 1}
                           for path in ("per_step", "fused_scan")}
#: the f32 SGD gate's batch (card against CPU, graphed against eager), held as
#: ``(p0 - p1) / lr`` relative to the largest of each tensor (at least 1), as UNet-3D's
#: and PredRNN++'s: FVD's gradients reach some 250 (the output bias) at this batch,
#: and its covariance part is a difference of nearly equal I3D features (the random
#: model's predictions barely vary across the batch), so f32 sums in another order (the
#: CPU's own step on 1 and on 8 threads, too) part by more than the elementwise form's
#: atol at elements near 0, and by far less than the limit relative to the largest
FVD_SGD_B = 4
FVD_SUITE_STEPS = 3


def fvd_matrix(b, seed, noise=0.05, width=400):
    r"""FVD's ``m = a a^T`` (``a = c_p^T c_t``) of ``b`` feature sets, the
    target the prediction plus ``noise``, f32 on the CPU: centring leaves it
    one exact zero eigenvalue."""
    import torch
    g = torch.Generator().manual_seed(seed)
    p = torch.randn((b, width), generator=g)
    t = p + noise * torch.randn((b, width), generator=g)
    a = ((p - p.mean(0)) @ (t - t.mean(0)).T) * (1.0 if b < 2 else 1.0 / (b - 1))
    return a @ a.T


def eig_errors(w, v, m, want_w):
    r"""E1's ``(eigenvalue error, reconstruction error)`` relative to the
    largest wanted eigenvalue and its orthogonality error, in f64."""
    import torch
    w, v, m, want_w = (x.double().cpu() for x in (w, v, m, want_w))
    scale = want_w.abs().max().item() or 1.0
    eye = torch.eye(m.shape[-1], dtype=torch.float64)
    return ((w - want_w).abs().max().item() / scale,
            (v @ torch.diag_embed(w) @ v.transpose(-1, -2) - m).abs().max().item() / scale,
            (v.transpose(-1, -2) @ v - eye).abs().max().item())


def drive_fvd_loss(card):
    r"""FVD as a loss inside the compiled steps (E1, ``csrc/sym_eig.cu``): E1
    against ``torch.linalg.eigh`` at :data:`E1_SIZES` on FVD-made matrices, on
    one with repeated eigenvalues and on a batch of three, twice bit-identical;
    its time at b=32 beside its bound and ``torch.linalg.eigh``'s;
    ``wasserstein2_torch`` on the card against the CPU, value and gradient;
    the Adam train step of paths (a) and (b) at b=32 bf16 with ``{"mse",
    "fvd"}``, eager and graphed, with exact launch counts (E1 once a call) and
    the replays under ``torch.cuda.set_sync_debug_mode("error")``; an f32 SGD
    step at b=4 on the card against the CPU and graphed against eager; and a
    ``VPSuite.train`` run of (a) with ``val_rec_criterion="fvd"``. Returns
    E1's entry of the kernels' JSON line."""
    import shutil
    import torch
    from vp_suite_tpu_torch.measure.fvd.fvd import wasserstein2_torch
    from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.ops.sym_eig import sym_eig, sym_eig_reference
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    t_phase = time.time()

    # E1 against torch.linalg.eigh
    worst = 0.0
    cases = [(f"FVD-made b={b}", fvd_matrix(b, SEED + b)) for b in E1_SIZES]
    q, _ = torch.linalg.qr(torch.randn(16, 16, generator=torch.Generator().manual_seed(SEED)))
    cases.append(("repeated eigenvalues b=16",
                  (q * torch.tensor([1.0] * 6 + [2.0] * 6 + [0.0] * 4)) @ q.T))
    cases.append(("a batch of three b=16", torch.stack([cases[-1][1], fvd_matrix(16, SEED),
                                                        torch.zeros(16, 16)])))
    for what, m in cases:
        m = m.cuda()
        w, v = sym_eig(m)
        again = sym_eig(m)
        card_w = sym_eig_reference(m)[0]
        exact = sym_eig_reference(m.double().cpu())[0]
        torch.cuda.synchronize()
        errs = eig_errors(w, v, m, exact)
        worst = max(worst, (w.double().cpu() - exact).abs().max().item())
        scale = exact.abs().max().item() or 1.0
        print(f"[fvd] E1 {what}: "
              f"eigenvalues against f64 {errs[0]:.3g} of the largest (the card's f32 "
              f"torch.linalg.eigh {(card_w.double().cpu() - exact).abs().max().item() / scale:.3g}, "
              f"E1 against it {(w - card_w).abs().max().item() / scale:.3g}), reconstruction "
              f"{errs[1]:.3g} of the largest, orthogonality {errs[2]:.3g} (limit {E1_TOL})")
        check(max(errs) <= E1_TOL, f"E1 {what}: errors {errs} above {E1_TOL}")
        check(torch.equal(w, again[0]) and torch.equal(v, again[1]),
              f"E1 {what}: two launches gave other bits")

    # E1's time at the FVD batch, beside its bound and torch.linalg.eigh's
    m = fvd_matrix(B, SEED + B).cuda()
    ms = graph_ms(lambda: sym_eig(m))
    eager = cuda_ms(lambda: sym_eig(m), warmup=3, iters=20)
    plain = cuda_ms(lambda: torch.linalg.eigh(m), warmup=3, iters=20)
    nbytes, ops = (2 * B * B + B) * 4, 9 * B ** 3
    bound, by = bound_ms(nbytes, ops, F32_FLOPS)
    print(f"[fvd] E1 b={B} f32: {ms * 1e3:.1f} us a launch from a CUDA graph (eager {eager * 1e3:.1f}"
          f" us), torch.linalg.eigh (the plain version and the one PyTorch call) {plain * 1e3:.1f}"
          f" us eager; bound {bound * 1e3:.3g} us by {by} ({nbytes} B, {ops} flops at 67 TFLOP/s)"
          f" on {card}")

    # the distance on the card against the CPU, value and gradient
    g = torch.Generator().manual_seed(SEED + 26)
    feats = [torch.randn((B, 400), generator=g) for _ in range(2)]
    got = []
    for device in ("cuda", "cpu"):
        p = feats[0].to(device).requires_grad_()
        d = wasserstein2_torch(p, feats[1].to(device))
        d.backward()
        got.append((d.item(), p.grad.cpu()))
    d_val = abs(got[0][0] - got[1][0]) / abs(got[1][0])
    d_grad = rel_err(got[0][1], got[1][1])
    print(f"[fvd] wasserstein2_torch b={B} x 400 on the card (E1) against the CPU (LAPACK): "
          f"{got[0][0]:.6f} vs {got[1][0]:.6f} ({d_val:.3g} relative), gradient {d_grad:.3g} of "
          f"its largest (limit {W2_RTOL})")
    check(d_val <= W2_RTOL and d_grad <= W2_RTOL, "wasserstein2_torch on the card parts from the CPU")

    # paths (a) and (b): the Adam train step with an FVD loss, eager and graphed
    run = {"context_frames": CTX, "pred_frames": PRED}
    losses = PredictionLossProvider({"losses_and_scales": FVD_LOSSES, "img_c": IMG[0]})
    frames = torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 26))
    batch = {"frames": frames}
    launches = {}
    for path, want in WANT_FVD_TRAIN_LAUNCHES.items():
        model_id, cfg = PATHS[path]
        model = build_model(model_id, SEED, "cuda", img_shape=IMG, action_size=0,
                            tensor_value_range=(0.0, 1.0), compute_dtype=torch.bfloat16, **cfg)
        state = create_train_state(model, lr=LR, seed=SEED)
        eager = make_train_step(model, run, losses, use_jit=False)
        graphed = make_train_step(model, run, losses)
        counts, totals = [], []
        for n in range(3):     # eager, the capture (and its replay), a replay
            counters = reset_counts()
            torch.cuda.set_sync_debug_mode("error" if n == 2 else 0)
            try:
                _, metrics = graphed(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            counts.append(read_counts(counters))
            totals.append({k: float(v) for k, v in metrics.items()})
        launches[path] = counts[0]
        print(f"[fvd] ({path}) Adam train step bf16 b={B} {CTX}->{PRED} with {FVD_LOSSES}: "
              f"launches in the eager call " + ", ".join(f"{k} {v}" for k, v in counts[0].items()
                                                         if v)
              + ", in the capture " + ", ".join(f"{k} {v}" for k, v in counts[1].items() if v)
              + f", from the host in a replay {sum(counts[2].values())}; losses "
              + "; ".join(", ".join(f"{k} {v:.4f}" for k, v in t.items()) for t in totals))
        check(counts[0] == want and counts[1] == want and counts[2] == _launches(),
              f"({path}) FVD train step: the eager call, the capture and a replay launched "
              f"{counts}, not {want}, {want} and none")
        check(all(math.isfinite(v) for t in totals for v in t.values()) and "fvd" in totals[0],
              f"({path}) FVD train step losses {totals}")
        for how, fn in (("eager", eager), ("graphed", graphed)):
            ms_, times = _median_ms(lambda: float(fn(state, batch)[1]["total"]), 3)
            dev_ms, wall = profile(f"FVD train step ({path}) {how}",
                                   lambda: float(fn(state, batch)[1]["total"]),
                                   pick=("sym_eig_kernel",))
            busy = f"{dev_ms:.2f} ms in {wall:.2f} ms ({dev_ms / wall:.0%})" if dev_ms else \
                "not measured"
            print(f"[fvd] ({path}) FVD train step {how}: median {ms_:.2f} ms (runs "
                  f"{', '.join(f'{t * 1e3:.2f}' for t in times)}); device {busy}")
        del model, state, eager, graphed
    torch.cuda.empty_cache()

    # f32 SGD at b=4: the card against the CPU, graphed against eager
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    lr, small = 1e-2, frames[:FVD_SGD_B]
    deltas, totals = {}, {}
    for how in ("cpu", "eager", "graphed"):
        device = "cpu" if how == "cpu" else "cuda"
        model = build_model("convlstm-shi", SEED, device, img_shape=IMG, action_size=0,
                            tensor_value_range=(0.0, 1.0), compute_dtype=torch.float32)
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        state = create_train_state(model, lr=lr, optimizer="sgd")
        step = make_train_step(model, run, losses, use_jit=how == "graphed")
        sb = {"frames": small.to(device)}
        if how == "graphed":    # its eager call and capture from p0, then a replay from p0
            step(state, sb)
            with torch.no_grad():
                for k, v in model.named_parameters():
                    v.copy_(p0[k])
            step(state, sb)
            with torch.no_grad():
                for k, v in model.named_parameters():
                    v.copy_(p0[k])
        _, metrics = step(state, sb)
        totals[how] = {k: float(v) for k, v in metrics.items()}
        deltas[how] = {k: ((p0[k] - v.detach()) / lr).cpu() for k, v in model.named_parameters()}
    same = sum(torch.equal(deltas["eager"][k], v) for k, v in deltas["graphed"].items())
    for a, b_ in (("eager", "cpu"), ("graphed", "eager")):
        rel, at = _worst_step_diff(deltas[a], deltas[b_])
        excess, _ = _delta_excess(deltas[a], deltas[b_])
        d_loss = abs(totals[a]["total"] - totals[b_]["total"]) / abs(totals[b_]["total"])
        print(f"[fvd] (per_step) f32 b={FVD_SGD_B} SGD step with {FVD_LOSSES}, {a} against "
              f"{b_}: losses {totals[a]} vs {totals[b_]} ({d_loss:.3g} relative); (p0-p1)/lr "
              f"max |diff| {rel:.3g} of the largest at {at} (limit {STEP_TOL}; elementwise, "
              f"printed: max(|diff| - rtol*|{b_}|) {excess:.3g})"
              + (f"; {same} of {len(deltas['eager'])} parameters bit-identical"
                 if a == "graphed" else ""))
        check(rel <= STEP_TOL and d_loss <= 1e-4,
              f"the f32 SGD step with an FVD loss, {a} against {b_}, parts")
    torch.backends.cudnn.deterministic = False

    # the facade: train (a) with an FVD loss, validating on FVD
    out = ROOT / "vp-suite-data" / "chip_smoke" / "fvd_run"
    shutil.rmtree(out, ignore_errors=True)
    suite = _mmf_suite(B * FVD_SUITE_STEPS)
    entry = suite.create_model(PATHS["per_step"][0], compute_dtype=torch.bfloat16, seed=SEED,
                               **PATHS["per_step"][1])
    torch.cuda.synchronize()
    counters = reset_counts()
    best = suite.train(epochs=1, steps_per_epoch=FVD_SUITE_STEPS, batch_size=B, context_frames=CTX,
                       pred_frames=PRED, no_vis=True, no_wandb=True, out_dir=str(out),
                       losses_and_scales=FVD_LOSSES, val_rec_criterion="fvd")
    torch.cuda.synchronize()
    got = read_counts(counters)
    want = {k: compiled_calls(FVD_SUITE_STEPS) * WANT_FVD_TRAIN_LAUNCHES["per_step"].get(k, 0)
            + compiled_calls(1) * (WANT_PREDICT_LAUNCHES["per_step"][k] + (k == "E1"))
            for k in KERNEL_IDS}
    with open(out / "metrics.jsonl") as f:
        val = [json.loads(line) for line in f]
    print(f"[fvd] VPSuite.train (per_step) bf16 b={B} with {FVD_LOSSES}, val_rec_criterion "
          f"'fvd', 1 epoch of {FVD_SUITE_STEPS} steps (compiled): launches "
          + ", ".join(f"{k} {v}" for k, v in got.items() if v)
          + f"; validation {val}; best {best}; frames/s {entry.train_epoch_fps}")
    check(got == want, f"VPSuite.train with an FVD loss launched {got}, not {want}")
    check(len(val) == 1 and math.isfinite(val[0]["fvd"]) and best == val[0]["fvd"],
          f"VPSuite.train with an FVD loss: validation {val}, best {best}")
    shutil.rmtree(out, ignore_errors=True)
    del suite, entry
    torch.cuda.empty_cache()
    print(f"[fvd] phase {time.time() - t_phase:.1f} s")
    return dict(name="sym_eig (E1)", route="cuda", source="vp_suite_tpu_torch/csrc/sym_eig.cu",
                replaces="vp_suite_tpu/measure/fvd/fvd.py:96 (jnp.linalg.eigh, left to XLA; "
                         "no Pallas kernel)",
                launches=launches["per_step"]["E1"], max_abs_err=worst, ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=plain)


def _delta_excess(got, want):
    r"""``(excess, name)``: the SGD gate's largest ``|got - want| - rtol *
    |want|`` over the parameters' (p0 - p1) / lr."""
    worst, worst_name = 0.0, ""
    for k, w in want.items():
        excess = ((got[k] - w).abs() - STEP_TOL * w.abs()).max().item()
        if excess > worst or not worst_name:
            worst, worst_name = excess, k
    return worst, worst_name


def _recording(model, key, seen):
    r"""Makes ``model`` keep a copy of its ``key`` argument at every forward
    in ``seen``: in a capture the copy is the graph's, which every replay
    overwrites with its own value."""
    forward = model.forward

    def recording(*args, **kwargs):
        seen.append(kwargs[key].detach().clone())
        return forward(*args, **kwargs)
    model.forward = recording


def graph_coins_and_masks():
    r"""PhyDNet's coins over :data:`GRAPH_COIN_EPOCHS` and PredRNN++'s masks over
    :data:`GRAPH_MASK_STEPS` steps, graphed against eager (f32, b=4, 16x16,
    5 -> 10, plain SGD), each step's value read after the step."""
    import torch
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    run = {"context_frames": CTX, "pred_frames": PRED}
    frames = {"frames": torch.rand((4, CTX + PRED, 16, 16, 3), device="cuda",
                                   generator=torch.Generator(device="cuda").manual_seed(SEED))}
    cases = {"phydnet": ("teacher_forcing", GRAPH_COIN_EPOCHS),
             "predrnn": ("mask_true", (0,) * GRAPH_MASK_STEPS)}
    for name, (key, epochs) in cases.items():
        model_id, cfg = FLOP_SMALL[name]
        values = {}
        for how in ("eager", "graphed"):
            model = build_model(model_id, SEED, "cuda", img_shape=(3, 16, 16), action_size=0,
                                tensor_value_range=(0.0, 1.0), **cfg)
            state = create_train_state(model, lr=GRAPH_LR, optimizer="sgd")
            if name == "predrnn":
                state.model_state = {"training_iteration": model.sampling_stop_iter - 3,
                                     "sampling_eta": 0.5}
            step = make_train_step(model, run, use_jit=how == "graphed")
            seen, values[how] = [], []
            _recording(model, key, seen)
            for epoch in epochs:
                step(state, frames, epoch)
                values[how].append(seen[-1].float().cpu())
        same = all(torch.equal(a, b) for a, b in zip(values["eager"], values["graphed"]))
        shown = [float(v.mean()) for v in values["graphed"]]
        print(f"[graphs] {name} f32 b=4 at 16x16: {key} of each graphed step (mean) "
              + ", ".join(f"{x:.3g}" for x in shown)
              + f"; equal to the eager steps' {same}")
        check(same, f"{name}: the graphed steps' {key} differ from the eager steps'")
        if name == "phydnet":
            check(shown[:3] == [1.0] * 3 and shown[-1] == 0.0,
                  f"phydnet: coins {shown} at epochs {epochs} (1 at epoch 0, 0 at 334)")
        else:
            check(all(x == 0.0 for x in shown[3:]) and 0.0 < shown[0] < 1.0,
                  f"predrnn: masks {shown}, random before the stop and 0 from it")


@contextlib.contextmanager
def tf32_flags(cudnn, matmul):
    r"""cuDNN's and cuBLAS's TF32 flags set to ``cudnn`` and ``matmul`` inside the block."""
    import torch
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def drive_new_models(dev, tf32_defaults):
    r"""UNet-3D, PredRNN++, PhyDNet, MinConvRNN, SimVP, PredFormer, ST-Phy and
    LSTM at bench width (b=32, 64x64 RGB, 5 -> 10, bf16 over f32 parameters,
    random weights from the seed): ``predict`` and the Adam train step
    (PhyDNet's and ST-Phy's at epoch 0, teacher-forced) with every kernel's
    launch count set to 0 just before and held at 0 just after, their
    compiled latencies and one profiled replay each, under
    PyTorch's default TF32 flags ``tf32_defaults``; the card against the CPU
    in f32 at b=2 with TF32 off (``predict``, one SGD step, UNet-3D's running
    statistics, PredRNN++'s schedule; the bf16 ``predict`` of
    ``NEW_BF16_PREDICT`` too; the action-conditional ``predict`` of
    ``NEW_ACTIONS``); and one short facade run per model
    (``load_dataset`` -> ``create_model`` -> ``train`` -> ``load_model``)."""
    import shutil
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    t_phase = time.time()
    gen = torch.Generator().manual_seed(SEED + 3)
    frames = torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]), generator=gen)
    batch = {"frames": frames.to(dev)}
    run_config = {"context_frames": CTX, "pred_frames": PRED}
    out = {}
    with tf32_flags(*tf32_defaults):
        for name in NEW_MODELS:
            out[name] = _time_new_model(name, frames, batch, run_config)

    # f32 at b=2 on the card (TF32 off) against the CPU: predict and one SGD step
    lr = 1e-2
    small = frames[:2]
    results = {}
    bf16_preds = {}
    for name in NEW_BF16_PREDICT:
        suite = VPSuite()
        _new_model(suite, name, compute_dtype=torch.bfloat16)
        bf16_preds[name] = suite.predict(small[:, :CTX], pred_frames=PRED).cpu()
    f64 = dict(compute_dtype=torch.float64)
    for device, precision, kw, names in (("cuda", "f32", dict(compute_dtype=torch.float32),
                                          NEW_MODELS), ("cpu", "f32", {}, NEW_MODELS),
                                         ("cuda", "f64", f64, NEW_STEP_F64),
                                         ("cpu", "f64", f64, NEW_STEP_WITNESS),
                                         ("cpu", "f32 one thread", {}, NEW_STEP_WITNESS)):
        threads = torch.get_num_threads()
        if precision == "f32 one thread":
            torch.set_num_threads(1)
        suite = VPSuite(device=device)
        for name in names:
            # PredRNN++ from sampling_stop_iter on: all-zero masks, so that the
            # card's and the CPU's generators draw alike
            extra = dict(sampling_stop_iter=0) if name == "predrnn" else {}
            model = _new_model(suite, name, **kw, **extra).model
            pred = suite.predict(small[:, :CTX], pred_frames=PRED, model_idx=-1).cpu()
            p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
            state = create_train_state(model, lr=lr, optimizer="sgd")
            step_config = {**run_config, "pred_frames": NEW_STEP_PRED.get(name, PRED)}
            _, metrics = make_train_step(model, step_config)(state,
                                                             {"frames": small.to(suite.device)})
            stats = {k: v.detach().cpu().clone() for k, v in model.named_buffers()
                     if k.endswith(("running_mean", "running_var"))}
            results[(name, device, precision)] = (pred, float(metrics["total"]),
                                       {k: ((p0[k] - v.detach()) / lr).cpu()
                                        for k, v in model.named_parameters()},
                                       stats, state.model_state)
        torch.set_num_threads(threads)
    for name in NEW_MODELS:
        card, host = results[(name, "cuda", "f32")], results[(name, "cpu", "f32")]
        d_pred = (card[0] - host[0]).abs().max().item()
        step_of = "f32"
        if name in NEW_STEP_WITNESS:
            ref = results[(name, "cpu", "f64")][2]
            w_card, _ = _worst_step_diff(card[2], ref)
            w_cpu, _ = _worst_step_diff(host[2], ref)
            w_one, _ = _worst_step_diff(results[(name, "cpu", "f32 one thread")][2], host[2])
            w_direct, _ = _worst_step_diff(card[2], host[2])
            print(f"[train] {name} f32 SGD step against the CPU's with f64 activations: card "
                  f"{w_card:.3g}, CPU {w_cpu:.3g} of the largest (p0-p1)/lr; f32 runs apart: "
                  f"the CPU on one thread from the CPU on {torch.get_num_threads()} threads "
                  f"{w_one:.3g}, the card from the CPU {w_direct:.3g}")
        if name in NEW_STEP_F64:
            step_of = "f64 activations"
            print(f"[train] {name}: the card's f32 step from f64 within "
                  f"{max(2 * w_cpu, NEW_STEP_REL):.3g} (twice the CPU's, or {NEW_STEP_REL})")
            check(w_card <= max(2 * w_cpu, NEW_STEP_REL),
                  f"{name}: the card's f32 step is further from f64 than the CPU's")
            worst, worst_name = _worst_step_diff(results[(name, "cuda", "f64")][2], ref)
        else:
            worst, worst_name = _worst_step_diff(card[2], host[2])
        d_stats = max([(card[3][k] - v).abs().max().item() for k, v in host[3].items()] or [0.0])
        d_loss = abs(card[1] - host[1])
        ok = (d_pred <= PREDICT_ATOL_F32 and worst <= NEW_STEP_REL
              and d_loss <= 1e-4 * abs(host[1]) and d_stats <= STATS_ATOL
              and card[4] == host[4])
        print(f"[train] {name} f32 b=2, card against CPU: predict max diff {d_pred:.3g} "
              f"(atol {PREDICT_ATOL_F32}); SGD step ({CTX}->{NEW_STEP_PRED.get(name, PRED)}) "
              f"loss {card[1]:.6f} vs {host[1]:.6f}, {step_of} "
              f"(p0-p1)/lr max |diff| / max(max|cpu|, 1) {worst:.3g} at {worst_name} "
              f"(limit {NEW_STEP_REL}); running statistics max diff {d_stats:.3g} "
              f"(atol {STATS_ATOL}, {len(host[3])} buffers); model_state {card[4]} vs "
              f"{host[4]}: {'ok' if ok else 'FAIL'}")
        check(ok, f"{name}: f32 predict or SGD step on the card disagrees with the CPU")
        if name in bf16_preds:
            d16 = (bf16_preds[name] - host[0]).abs().max().item()
            largest = host[0].abs().max().item()
            limit = PREDICT_ATOL_BF16 * max(1.0, largest)
            print(f"[predict] {name} b=2: card bf16 against the CPU f32, max diff {d16:.3g} "
                  f"(limit {limit:.3g}: {PREDICT_ATOL_BF16} x max(1, |f32| max {largest:.3g}))")
            check(d16 <= limit, f"{name}: bf16 predict on the card disagrees with the CPU")

    # the action-conditional models, f32 b=2: the card's predict against the CPU's
    actions = torch.rand((2, CTX + PRED, 3), generator=gen)
    for name in NEW_ACTIONS:
        preds = []
        for device in ("cuda", "cpu"):
            suite = VPSuite(device=device)
            _new_model(suite, name, action_conditional=True, action_size=3,
                       compute_dtype=torch.float32)
            counters = reset_counts()
            preds.append(suite.predict(small[:, :CTX], actions=actions, pred_frames=PRED).cpu())
            if device == "cuda":
                _zero_launches(name, "one action-conditional predict", counters)
        unconditioned = suite.predict(small[:, :CTX], actions=torch.zeros_like(actions),
                                      pred_frames=PRED)
        d_act = (preds[0] - preds[1]).abs().max().item()
        moved = (preds[1] - unconditioned).abs().max().item()
        print(f"[predict] {name} action-conditional (3 channels) f32 b=2, card against CPU: "
              f"max diff {d_act:.3g} (atol {PREDICT_ATOL_F32}); the actions move the CPU's "
              f"prediction by {moved:.3g}")
        check(d_act <= PREDICT_ATOL_F32 and moved > 0.0,
              f"{name}: the action-conditional predict on the card disagrees with the CPU, or "
              f"ignores the actions")

    # the facade: load_dataset -> create_model -> train -> load_model
    out_root = ROOT / "vp-suite-data" / "chip_smoke_new"
    shutil.rmtree(out_root, ignore_errors=True)
    for name in NEW_MODELS:
        suite = VPSuite()
        suite.load_dataset("MMF", digit_source="synthetic", img_size=IMG[1], backend="device",
                           n_seqs={"train": B * NEW_SUITE_STEPS, "val": B, "test": B})
        entry = suite.create_model(NEW_MODELS[name][0], compute_dtype=torch.bfloat16, seed=SEED,
                                   **NEW_MODELS[name][1])
        counters = reset_counts()
        best = suite.train(epochs=1, steps_per_epoch=NEW_SUITE_STEPS, out_dir=str(out_root / name),
                           batch_size=B, context_frames=CTX, pred_frames=PRED, no_vis=True,
                           no_wandb=True)
        _zero_launches(name, f"train ({NEW_SUITE_STEPS} steps and a validation)", counters)
        check(math.isfinite(best) and entry.state.step == NEW_SUITE_STEPS,
              f"{name}: train gave best {best} after {entry.state.step} steps")
        loaded = VPSuite().load_model(str(out_root / name), "best_model")
        d = (loaded.model.state_dict(), entry.model.state_dict())
        check(d[0].keys() == d[1].keys() and all(torch.equal(d[0][k], d[1][k]) for k in d[1])
              and loaded.state.model_state == entry.state.model_state,
              f"{name}: load_model did not restore the parameters, buffers and schedule")
        suite.models.append(loaded)
        diff = (suite.predict(frames[:, :CTX], pred_frames=PRED, model_idx=-1)
                - suite.predict(frames[:, :CTX], pred_frames=PRED, model_idx=-2)).abs().max().item()
        print(f"[suite] {name}: train bf16 b={B} {CTX}->{PRED}, {NEW_SUITE_STEPS} steps: "
              f"{entry.train_epoch_fps[-1]:.1f} frames/s, validation MSE {best:.2f}; "
              f"model_state {entry.state.model_state}; load_model(best_model) predict against "
              f"the trained entry's: max diff {diff:.3g}")
        check(diff == 0.0, f"{name}: the loaded model predicts other frames")
    shutil.rmtree(out_root, ignore_errors=True)
    print(f"[new models] the phase took {time.time() - t_phase:.1f} s")
    return out


#: the tooling phase (``drive_tooling``): the visualised runs' training steps and items
VIS_STEPS, N_VIS = 3, 2
#: hyperopt on the fused path: trials, and steps of each trial's one epoch
HYPEROPT_TRIALS, HYPEROPT_STEPS = 3, 2
#: the profiled run (per-step path): epochs and steps per epoch; epoch 2 is traced,
#: and its trace must name K1's and K2's Triton kernels
PROFILE_EPOCHS, PROFILE_STEPS = 2, 2
PROFILE_KERNELS = ("_convlstm_gate_fwd", "_convlstm_gate_bwd")
#: the batches a batch-polymorphic exported program is run at
EXPORT_POLY_BATCHES = (8, B)
#: the kernel operator each path's exported graph calls
EXPORT_OPS = {"per_step": "convlstm_gate_forward", "fused_scan": "convlstm_scan_forward",
              "trajgru": "warp_sample_forward"}
#: the registry models at a small size (b=2, 16x16 unless set, 3 -> 3), where the card's
#: FLOP count of ``predict`` and of the train step must equal the CPU's
FLOP_SMALL = {
    "per_step": ("convlstm-shi", {}), "fused_scan": ("convlstm-shi", PATHS["fused_scan"][1]),
    "trajgru": ("trajgru", {}), "unet3d": ("unet-3d", dict(temporal_dim=3, features=(4, 8))),
    "predrnn": ("predrnn-pp", dict(num_hidden=(8, 8, 8))),
    "phydnet": ("phy", dict(convlstm_hidden_dims=(16, 64))),
    "min_conv_rnn": ("min-conv-rnn", dict(hidden_dim=16)),
    "simvp": ("simvp", dict(hid_s=8, hid_t=16, n_trans=2, in_frames=3)),
    "pred_former": ("pred-former", dict(patch_size=8, dim=32, depth=2, heads=2)),
    "st_phy": ("st-phy", dict(img_shape=(3, 32, 32), num_layers=2, st_cell_channels=8,
                              phycell_channels=9, phycell_kernel_size=(3, 3))),
    "lstm": ("lstm", dict(img_shape=(3, 32, 32), bottleneck_dim=32, lstm_hidden_dim=32,
                          lstm_num_layers=2)),
}


def drive_tooling(dev, card, serve, train, predict_ms, new_times):
    r"""The facade's tooling on the card, each part with its launch counts set
    to 0 just before and held exactly just after: visualisation during
    ``train`` and ``test``, ``hyperopt``, ``profile_dir``, FLOP counts of every
    model, the ``torch.export`` programs and the import of reference
    checkpoints. ``predict_ms`` and ``new_times`` are the latencies the
    smoke measured (``time_paths``, ``drive_new_models``); run directories go
    under ``vp-suite-data/chip_smoke/tooling``, deleted at the end."""
    import shutil
    from vp_suite_tpu_torch.defaults import SETTINGS
    t_phase = time.time()
    out_root = ROOT / "vp-suite-data" / "chip_smoke" / "tooling"
    shutil.rmtree(out_root, ignore_errors=True)
    smoke_run_path = SETTINGS._run_path
    try:
        parts = (("visualisation", lambda: _tooling_vis(out_root)),
                 ("hyperopt", lambda: _tooling_hyperopt(out_root)),
                 ("profile_dir", lambda: _tooling_profile(out_root)),
                 ("FLOPs", lambda: _tooling_flops(dev, card, serve, train, predict_ms,
                                                  new_times)),
                 ("export", lambda: _tooling_export(dev, serve, out_root)),
                 ("reference checkpoints", lambda: _tooling_reference(out_root)))
        for name, part in parts:
            t0 = time.time()
            part()
            print(f"[tooling] {name}: {time.time() - t0:.1f} s")
    finally:
        SETTINGS._run_path = smoke_run_path
        shutil.rmtree(out_root, ignore_errors=True)
    print(f"[tooling] the phase took {time.time() - t_phase:.1f} s")


def _mmf_suite(train_seqs):
    r"""A ``VPSuite`` on the card with on-the-fly Moving MNIST at 64x64 (the
    card's batches for training)."""
    from vp_suite_tpu_torch import VPSuite
    suite = VPSuite()
    suite.load_dataset("MMF", digit_source="synthetic", img_size=IMG[1], backend="device",
                       n_seqs={"train": train_seqs, "val": B, "test": B})
    return suite


def _tooling_vis(out_root):
    r"""``train`` (1 epoch of ``VIS_STEPS``, ``vis_every=1``) and a brief
    ``test`` with ``vis_compare`` on the per-step and fused paths, ``n_vis`` 2:
    K1 or K3 counted exactly with the visualisations' predictions (one
    sequence each; CopyLastFrame launches none); every PNG read back by
    ``read_png`` bit for bit against the array written, every GIF's header,
    frame count, loop block and delays."""
    import numpy as np
    import torch
    import vp_suite_tpu_torch.utils.visualization as vis
    from vp_suite_tpu_torch.defaults import SETTINGS
    from vp_suite_tpu_torch.utils.image_io import read_gif, read_png
    written = {"png": [], "gif": []}
    real_png, real_gif = vis.write_png, vis.write_gif

    def png(fp, img):
        written["png"].append((Path(fp), np.array(img)))
        real_png(fp, img)

    def gif(fp, frames, fps=4):
        written["gif"].append((Path(fp), len(frames), fps))
        real_gif(fp, frames, fps=fps)

    run_kw = dict(batch_size=B, context_frames=CTX, pred_frames=PRED, no_wandb=True)
    vis.write_png, vis.write_gif = png, gif
    try:
        for path in ("per_step", "fused_scan"):
            suite = _mmf_suite(B * VIS_STEPS)
            suite.create_model(PATHS[path][0], compute_dtype=torch.bfloat16, seed=SEED,
                               **PATHS[path][1])
            run = out_root / f"vis_{path}"
            torch.cuda.synchronize()
            counters = reset_counts()
            suite.train(epochs=1, steps_per_epoch=VIS_STEPS, out_dir=str(run), vis_every=1,
                        n_vis=N_VIS, **run_kw)
            torch.cuda.synchronize()
            launches = read_counts(counters)
            want = {k: v + compiled_calls(N_VIS) * WANT_PREDICT_LAUNCHES[path][k]
                    for k, v in want_suite_launches(path, 1, VIS_STEPS).items()}
            print(f"[tooling] train {path} with vis_every=1, n_vis={N_VIS}: kernel launches "
                  + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
            check(launches == want, f"{path}: train with visualisation launched {launches}, "
                                    f"not {want}")
            gifs = sorted(p.name for p in (run / "vis_ep_001").iterdir())
            check(gifs == [f"vis_{i}.gif" for i in range(N_VIS)],
                  f"{path}: train wrote {gifs} to vis_ep_001")

            suite.load_dataset("MMF", split="test", digit_source="synthetic", img_size=IMG[1],
                               n_seqs=TEST_SEQS)
            SETTINGS._run_path = run / "test_runs"
            counters = reset_counts()
            t0 = time.perf_counter()
            suite.test(brief_test=True, metrics=["mse"], vis_compare=True, n_vis=N_VIS,
                       **{k: v for k, v in run_kw.items() if k != "batch_size"})
            torch.cuda.synchronize()
            launches = read_counts(counters)
            # the visualised items have the test batches' shape: one compiled predictor
            want = {k: compiled_calls(TEST_BATCHES + N_VIS) * v
                    for k, v in WANT_PREDICT_LAUNCHES[path].items()}
            print(f"[tooling] test {path} with vis_compare, n_vis={N_VIS}: "
                  f"{time.perf_counter() - t0:.2f} s, kernel launches "
                  + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
            check(launches == want, f"{path}: test with visualisation launched {launches}, "
                                    f"not {want}")
            (test_dir,) = (run / "test_runs" / "output").iterdir()
            files = {p.name for p in test_dir.iterdir()}
            check({"vis_info.txt", "compare_0.png", "compare_1.png",
                   "vis_0_EF-ConvLSTM_(Shi_et_al.).gif", "vis_1_CopyLastFrame.gif"} <= files,
                  f"{path}: test wrote {sorted(files)}")
    finally:
        vis.write_png, vis.write_gif = real_png, real_gif
    for fp, img in written["png"]:
        check(np.array_equal(read_png(fp), img), f"{fp} does not read back bit for bit")
    for fp, n, fps in written["gif"]:
        head = fp.read_bytes()[:200]
        frames, info = read_gif(fp)
        check(head[:6] == b"GIF89a" and b"NETSCAPE2.0" in head and info["loop"] == 0
              and len(frames) == n == CTX + PRED
              and info["delays_ms"] == [round(100 / fps) * 10] * n,
              f"{fp}: header {head[:6]}, {len(frames)} frames of {n}, {info}")
    print(f"[tooling] {len(written['png'])} PNGs read back bit for bit with read_png; "
          f"{len(written['gif'])} GIFs: GIF89a, {CTX + PRED} frames each, NETSCAPE2.0 loop 0, "
          f"250 ms a frame")


def _tooling_hyperopt(out_root):
    r"""``hyperopt`` on the fused path: ``HYPEROPT_TRIALS`` trials of one
    epoch of ``HYPEROPT_STEPS`` steps, searching ``lr`` (log scale) and the
    loss mix; K3s and K4 exactly 6 a step, K3 6 per trial's validation batch."""
    import torch
    suite = _mmf_suite(B * HYPEROPT_STEPS)
    suite.create_model(PATHS["fused_scan"][0], compute_dtype=torch.bfloat16, seed=SEED,
                       **PATHS["fused_scan"][1])
    space = {"lr": {"min": 1e-5, "max": 1e-3, "scale": "log"},
             "losses_and_scales": {"choices": [{"mse": 1.0}, {"mse": 1.0, "l1": 1.0}]}}
    torch.cuda.synchronize()
    counters = reset_counts()
    best = suite.hyperopt(space, n_trials=HYPEROPT_TRIALS, epochs=1,
                          steps_per_epoch=HYPEROPT_STEPS, batch_size=B, context_frames=CTX,
                          pred_frames=PRED, no_vis=True, no_wandb=True,
                          out_dir=str(out_root / "hyperopt"))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    want = {k: HYPEROPT_TRIALS * v
            for k, v in want_suite_launches("fused_scan", 1, HYPEROPT_STEPS).items()}
    print(f"[tooling] hyperopt fused_scan, {HYPEROPT_TRIALS} trials of {HYPEROPT_STEPS} steps: "
          f"kernel launches " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"; best_params {best}")
    check(launches == want, f"hyperopt launched {launches}, not {want}")
    check(set(best) == set(space) and 1e-5 <= best["lr"] <= 1e-3, f"best_params {best}")


def _tooling_profile(out_root):
    r"""``train`` with ``profile_dir`` on the per-step path: launches exact,
    one Chrome trace (epoch 2's training loop) that names K1's and K2's
    kernels."""
    import torch
    suite = _mmf_suite(B * PROFILE_STEPS)
    suite.create_model(PATHS["per_step"][0], compute_dtype=torch.bfloat16, seed=SEED,
                       **PATHS["per_step"][1])
    prof = out_root / "profile"
    torch.cuda.synchronize()
    counters = reset_counts()
    suite.train(epochs=PROFILE_EPOCHS, steps_per_epoch=PROFILE_STEPS, batch_size=B,
                context_frames=CTX, pred_frames=PRED, no_vis=True, no_wandb=True,
                out_dir=str(out_root / "profiled"), profile_dir=str(prof))
    torch.cuda.synchronize()
    launches = read_counts(counters)
    want = want_suite_launches("per_step", PROFILE_EPOCHS, PROFILE_STEPS)
    check(launches == want, f"train with profile_dir launched {launches}, not {want}")
    traces = sorted(prof.iterdir())
    check([t.name for t in traces] == ["trace_epoch_002.json"], f"profile_dir holds {traces}")
    text = traces[0].read_text()
    named = {k: text.count(k) for k in PROFILE_KERNELS}
    print(f"[tooling] profile_dir: {traces[0].name}, {len(text) / 2 ** 20:.1f} MiB; kernel "
          f"names in it: " + ", ".join(f"{k} {v}" for k, v in named.items()))
    check(all(named.values()), f"the trace does not name the gate kernels: {named}")


def _tooling_flops(dev, card, serve, train, predict_ms, new_times):
    r"""FLOPs of ``count_flops``: at ``FLOP_SMALL``'s sizes the card's count
    of ``predict`` and of the train step equals the CPU's; at bench shapes,
    for paths (a)-(c) and the eight other models, TFLOP per call and the
    achieved share of the bf16 peak at the latencies the smoke measured."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    from vp_suite_tpu_torch.utils.flops import count_flops
    small_cfg = {"context_frames": 3, "pred_frames": 3}
    for name, (model_id, kw) in FLOP_SMALL.items():
        kw = {**dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0)), **kw}
        _, h, w = kw["img_shape"]
        frames = torch.rand((2, 6, h, w, 3), generator=torch.Generator().manual_seed(SEED))
        counts = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            model = build_model(model_id, SEED, device, **kw)
            batch = {"frames": frames.to(device), "actions": torch.zeros(2, 6, 1, device=device)}
            step = make_train_step(model, small_cfg) if model.TRAINABLE else None
            counts[where] = (
                count_flops(make_predict_fn(model, small_cfg), batch),
                count_flops(step, create_train_state(model), batch) if step else 0)
        print(f"[flops] {name} at b=2 {h}x{w} 3->3: predict, train step on the card "
              f"{counts['card']}, on the CPU {counts['cpu']}")
        check(counts["card"] == counts["cpu"], f"{name}: the card counts {counts['card']} FLOPs, "
                                               f"the CPU {counts['cpu']}")

    frames = serve["frames"]
    rows = []
    for i, name in enumerate(PATHS):
        s = train["steps"][name]
        model = serve["suite"].models[i].model   # an eager predict: a replay runs no ops
        serving = make_predict_fn(model, {"context_frames": CTX, "pred_frames": PRED},
                                  use_jit=False)
        rows.append((name, count_flops(serving, {"frames": frames.to(dev)}), predict_ms[name],
                     count_flops(s["step"], s["state"], train["batch"]), s["lat"]))
    run_config = {"context_frames": CTX, "pred_frames": PRED}
    batch = {"frames": torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]), device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(SEED))}
    for name in NEW_MODELS:
        suite = VPSuite()
        model = _new_model(suite, name, compute_dtype=torch.bfloat16).model
        pred = count_flops(suite.predict, batch["frames"][:, :CTX], pred_frames=PRED)
        step = make_train_step(model, run_config)
        rows.append((name, pred, new_times[name]["graph_predict_ms"],
                     count_flops(step, create_train_state(model, lr=LR, seed=SEED), batch),
                     new_times[name]["graph_step_ms"]))
        del suite, model, step
    for name, pred, pred_ms, step, step_ms in rows:
        print(f"[flops] {name} bf16 b={B} {CTX}->{PRED} at {IMG[1]}x{IMG[2]} on {card}: predict "
              f"{pred / 1e12:.4f} TFLOP in {pred_ms:.2f} ms ({pred / pred_ms / 1e9:.2f} TFLOP/s, "
              f"{pred / pred_ms * 1e3 / BF16_TENSOR_FLOPS:.2%} of 989); train step "
              f"{step / 1e12:.4f} TFLOP in {step_ms:.2f} ms ({step / step_ms / 1e9:.2f} TFLOP/s, "
              f"{step / step_ms * 1e3 / BF16_TENSOR_FLOPS:.2%} of 989)")
        check(step > pred > 0, f"{name}: {pred} FLOPs a predict, {step} a train step")


def _tooling_export(dev, serve, out_root):
    r"""``export_predictor`` -> ``save_predictor`` -> ``load_predictor`` of
    each path's bf16 model, batch-polymorphic (run at b=8 and b=32): the
    graph calls the kernel's operator, each call launches K1 45, K3 6 or the
    warp forward 45 times, the output matches ``VPSuite.predict`` within the
    bf16 gate, and the loaded program's latency beside ``predict``'s."""
    import torch
    from vp_suite_tpu_torch.serving import export_predictor, load_predictor, save_predictor
    suite, frames = serve["suite"], serve["frames"]
    x = frames.to(dev)
    for i, name in enumerate(PATHS):
        model = suite.models[i].model
        t0 = time.time()
        exported = export_predictor(model, None, CTX, PRED, batch_size=None)
        t_export = time.time() - t0
        ops = {str(n.target) for n in exported.graph.nodes
               if "vp_suite_tpu_torch" in str(n.target)}
        check(ops == {f"vp_suite_tpu_torch.{EXPORT_OPS[name]}.default"},
              f"{name}: the exported graph calls {ops}")
        path = save_predictor(exported, out_root / f"{name}_poly.pt2")
        predict = load_predictor(path)
        for b in EXPORT_POLY_BATCHES:
            want = suite.predict(frames[:b], pred_frames=PRED, model_idx=i)
            torch.cuda.synchronize()
            counters = reset_counts()
            got = predict(x[:b])
            torch.cuda.synchronize()
            launches = read_counts(counters)
            check(launches == WANT_PREDICT_LAUNCHES[name],
                  f"{name}: one call of the exported program launched {launches}")
            diff = (got - want).abs().max().item()
            check(tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
                  and diff <= PREDICT_ATOL_BF16,
                  f"{name}: the exported program gives {tuple(got.shape)} {got.dtype}, "
                  f"max diff {diff:.3g} from predict")
            prog_ms, _ = _median_ms(lambda: (predict(x[:b]), torch.cuda.synchronize()), 3)
            pred_ms, _ = _median_ms(lambda: (suite.predict(frames[:b], pred_frames=PRED,
                                                           model_idx=i),
                                             torch.cuda.synchronize()), 3)
            mib = path.stat().st_size / 2 ** 20
            print(f"[export] {name} bf16 batch-polymorphic"
                  f" (exported in {t_export:.1f} s, {mib:.1f} MiB) at b={b}: launches "
                  + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
                  + f"; max diff from predict {diff:.3g} (atol {PREDICT_ATOL_BF16}); loaded "
                  f"program median {prog_ms:.2f} ms, predict {pred_ms:.2f} ms (its frames "
                  f"copied from the host)")


def _standin_class(base, name):
    r"""A subclass of the port's model class ``base`` named as the reference's
    class, registered in this module so that ``torch.save`` pickles it by name."""
    cls = type(name, (base,), {"__module__": __name__, "__qualname__": name})
    globals()[name] = cls
    return cls


def _tooling_reference(out_root):
    r"""A reference-named stand-in module (an f32 EF-ConvLSTM on the card)
    and its ``state_dict``, ``torch.save`` d; ``load_torch_model`` of the
    module and ``model_from_import`` of the state dict: ``predict`` bit-equal
    to the source model's, with cuDNN's deterministic algorithms."""
    import copy
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.utils.torch_import import (import_state_dict, import_torch_model,
                                                       model_from_import)
    src_suite = VPSuite()
    src = src_suite.create_model("convlstm-shi", img_shape=IMG, action_size=0,
                                 tensor_value_range=(0.0, 1.0), seed=SEED + 5).model
    ckpt = out_root / "reference"
    ckpt.mkdir(parents=True, exist_ok=True)
    standin = copy.deepcopy(src)
    standin.__class__ = _standin_class(type(src), "EF_ConvLSTM")
    torch.save(standin, ckpt / "best_model.pth")
    torch.save(src.state_dict(), ckpt / "state_dict.pth")
    frames = torch.rand((B, CTX, IMG[1], IMG[2], IMG[0]),
                        generator=torch.Generator().manual_seed(SEED + 6))
    # f32 convolutions may take a cuDNN algorithm that sums in another order from call to
    # call (one model's predict twice differs by 1.5e-8 on an H100): deterministic ones here
    cudnn_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = src_suite.predict(frames, pred_frames=PRED)
        again = src_suite.predict(frames, pred_frames=PRED)
        suite = VPSuite()
        entry = suite.load_torch_model(str(ckpt))
        got = suite.predict(frames, pred_frames=PRED)
        model_id, kwargs, _ = import_torch_model(standin)
        sd = import_state_dict(model_id, torch.load(ckpt / "state_dict.pth"))
        suite.models.append(type(entry)(model_from_import(model_id, kwargs, sd,
                                                          device=suite.device), model_id))
        got_sd = suite.predict(frames, pred_frames=PRED)
    finally:
        torch.backends.cudnn.deterministic = cudnn_deterministic
    print(f"[tooling] reference checkpoint ({type(standin).__name__}, {model_id}), f32 with "
          f"cuDNN's deterministic algorithms: the source's predict twice max diff "
          f"{(again - want).abs().max().item():.3g}, load_torch_model's "
          f"{(got - want).abs().max().item():.3g}, the state dict's "
          f"{(got_sd - want).abs().max().item():.3g} (must be 0)")
    check(entry.model_id == "convlstm-shi" and torch.equal(got, want) and torch.equal(got_sd, want),
          "an imported reference checkpoint predicts other frames than its source")


#: the data-parallel runs (``drive_parallel``): each child process's time
#: limit, the facade's runs in (i) as (path, fsdp, checkpoint backend), their
#: steps, and the f32 runs' batch and learning rate in (i) and (ii)
PAR_TIMEOUT = 240
PAR_RUNS = (("fused_scan", True, "orbax"), ("per_step", False, "msgpack"))
PAR_STEPS = 3
PAR_B = 8
PAR_LR = 1e-2
#: f32 parameters of a run in a group of one against the same run without one
PAR_REL = 1e-6


def drive_parallel(card):
    r"""Data-parallel training in child processes of this script
    (:func:`parallel_worker`): (i) a world of one over NCCL through the
    facade, (ii) two processes on the one card over gloo; then, here, (ii)'s
    step against the one-process step and its sharded checkpoint through
    ``load_model``. Deletes its runs under ``vp-suite-data/chip_smoke/parallel``."""
    import shutil
    import torch
    from vp_suite_tpu_torch import VPSuite
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    t_phase = time.time()
    out_root = ROOT / "vp-suite-data" / "chip_smoke" / "parallel"
    shutil.rmtree(out_root, ignore_errors=True)
    out_root.mkdir(parents=True)
    print(f"[parallel] {card}")
    try:
        _run_world("facade", 1, out_root)
        _run_world("pair", 2, out_root)
        ranks = [torch.load(out_root / f"pair_{r}.pt", weights_only=False) for r in range(2)]
        frames = _par_frames().cuda()
        for path, (model_id, cfg) in PATHS.items():
            if path == "trajgru":
                continue
            got = [ranks[r][path] for r in range(2)]
            sharded = got[0]["sharded"]
            same = all(torch.equal(got[0]["params"][k], got[1]["params"][k])
                       for k in got[0]["params"] if k not in sharded)
            print(f"[parallel] (ii) {path}: the two processes' replicated parameters are equal: "
                  f"{same}; {len(sharded)} sharded by FSDP, whole from both processes' rows")
            check(same, f"(ii) {path}: the two processes' parameters differ")
            for k in sharded:
                got[0]["params"][k] = torch.cat([got[0]["params"][k], got[1]["params"][k]])
            model = build_model(model_id, SEED, "cuda", **_par_kwargs(), **cfg)
            p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
            state = create_train_state(model, lr=PAR_LR, optimizer="sgd")
            _, metrics = make_train_step(model, {"context_frames": CTX, "pred_frames": PRED})(
                state, {"frames": frames})
            worst, worst_name = 0.0, ""
            for k, v in model.named_parameters():
                want = ((p0[k] - v.detach()) / PAR_LR).cpu()
                mine = (p0[k].cpu() - got[0]["params"][k]) / PAR_LR
                excess = ((mine - want).abs() - STEP_TOL * want.abs()).max().item()
                if excess > worst or not worst_name:
                    worst, worst_name = excess, k
            loss = float(metrics["total"])
            ok = worst <= STEP_TOL and abs(got[0]["loss"] - loss) <= 1e-4 * abs(loss)
            print(f"[parallel] (ii) {path} f32 SGD step of two processes (gloo, b={PAR_B // 2} "
                  f"each{', FSDP' if got[0]['fsdp'] else ''}) against one process at b={PAR_B}: "
                  f"loss {got[0]['loss']:.6f} vs {loss:.6f}; (p0-p1)/lr: max(|diff| - rtol*|one|) "
                  f"{worst:.3g} at {worst_name} (rtol {STEP_TOL}, must stay <= atol {STEP_TOL}); "
                  f"launches per process {got[0]['launches']}: {'ok' if ok else 'FAIL'}")
            check(ok, f"(ii) {path}: the two-process step disagrees with the one-process step")
            check(got[0]["launches"] == got[1]["launches"]
                  == {k: v for k, v in WANT_TRAIN_LAUNCHES[path].items() if v},
                  f"(ii) {path}: the step launched {got[0]['launches']}, not "
                  f"{WANT_TRAIN_LAUNCHES[path]}")

        # the sharded checkpoint of (ii)'s fused path, here without a group
        entry = VPSuite().load_model(str(out_root), "pair_ckpt")
        check(not torch.distributed.is_initialized(), "the smoke's own process joined a group")
        model_id, cfg = PATHS["fused_scan"]
        ref = build_model(model_id, SEED, "cuda", **_par_kwargs(), **cfg)
        ref.load_state_dict({k: v.cuda() for k, v in ranks[0]["fused_scan"]["params"].items()})
        suite = VPSuite()
        suite.models.append(_entry(ref, model_id))
        cudnn = torch.backends.cudnn
        cudnn.deterministic, cudnn.benchmark = True, False   # bit-equal convolutions
        want = suite.predict(frames[:, :CTX], pred_frames=PRED)
        suite.models.append(entry)
        torch.cuda.synchronize()
        counters = reset_counts()
        got = suite.predict(frames[:, :CTX], pred_frames=PRED)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        cudnn.deterministic = False
        diff = (got - want).abs().max().item()
        print(f"[parallel] (ii) the sharded checkpoint loaded without a group (step "
              f"{entry.state.step}): predict launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
              + f"; max |diff| against the processes' parameters {diff:.3g}")
        check(launches == WANT_PREDICT_LAUNCHES["fused_scan"],
              f"(ii) the loaded checkpoint's predict launched {launches}")
        check(diff == 0.0 and entry.state.step == 1,
              "(ii) the loaded checkpoint predicts other frames than the processes' parameters")
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    print(f"[parallel] the phase took {time.time() - t_phase:.1f} s")


def _entry(model, model_id):
    from vp_suite_tpu_torch.vpsuite import ModelEntry
    return ModelEntry(model.eval(), model_id)


def _par_kwargs():
    return dict(img_shape=IMG, action_size=0, tensor_value_range=(0.0, 1.0))


def _par_frames():
    import torch
    return torch.rand((PAR_B, CTX + PRED, IMG[1], IMG[2], IMG[0]),
                      generator=torch.Generator().manual_seed(SEED + 7))


def _run_world(task, world, out_root):
    r"""Runs ``task`` of :func:`parallel_worker` in ``world`` child processes
    (torchrun's variables, all on card 0, a free loopback port) within
    PAR_TIMEOUT seconds; prints their output; fails if one fails or is late."""
    late, rcs = _end_world(*_start_world(task, world, out_root))
    check(not late, f"{task}: the world did not end within {PAR_TIMEOUT} s")
    check(all(rc == 0 for rc in rcs), f"{task}: a process of the world failed")


def _start_world(task, world, out_root):
    r"""Starts the ``world`` child processes of ``task``; returns what
    :func:`_end_world` takes."""
    import os
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    logs = [open(out_root / f"{task.replace(':', '_')}_{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--parallel-worker",
                               task, str(out_root)], env={**env, "RANK": str(r)},
                              stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT))
             for r, log in enumerate(logs)]
    return task, procs, logs, time.time()


def _end_world(task, procs, logs, t0):
    r"""Waits for a world of :func:`_start_world` until PAR_TIMEOUT seconds
    after its start (then kills what is left); prints its output; returns
    ``(late, exit codes)``."""
    late = False
    try:
        for p in procs:
            p.wait(timeout=max(1.0, PAR_TIMEOUT - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        late = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        log.seek(0)
        lines = log.read().splitlines()
        log.close()
        print("\n".join(lines[-60:] if p.returncode else
                        [ln for ln in lines if ln.startswith(("[parallel]", "[tp]", "[mp]"))]))
    print(f"[parallel] {task}: {len(procs)} process(es) in {time.time() - t0:.1f} s, exit codes "
          f"{[p.returncode for p in procs]}")
    return late, [p.returncode for p in procs]


def parallel_worker(task, out_dir):
    r"""One child process of :func:`drive_parallel` (torchrun's variables in
    its environment): ``facade`` is (i), ``pair`` one process of (ii)."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from vp_suite_tpu_torch.parallel import initialize_multihost
    if task == "facade":
        _parallel_facade(Path(out_dir))
    elif task == "tp1":
        _tp_world_of_one(Path(out_dir))
    elif task in ("tp2", "tp4", "mp2"):
        initialize_multihost(backend="gloo")
        try:
            {"tp2": _tp_pair, "tp4": _tp_2d, "mp2": _model_parallel_pair}[task](Path(out_dir))
        finally:
            torch.distributed.destroy_process_group()
    else:
        initialize_multihost(backend="gloo")
        try:
            _parallel_pair(Path(out_dir))
        finally:
            torch.distributed.destroy_process_group()


def _par_suite(path, dtype, batch):
    r"""A ``VPSuite`` on the card with on-the-fly Moving MNIST (the card's
    batches) for PAR_STEPS steps of ``batch`` and one validation batch, and
    the path's model in ``dtype``."""
    import torch
    from vp_suite_tpu_torch import VPSuite
    suite = VPSuite()
    suite.load_dataset("MMF", digit_source="synthetic", img_size=IMG[1], backend="device",
                       n_seqs={"train": batch * PAR_STEPS, "val": batch, "test": batch})
    entry = suite.create_model(PATHS[path][0], compute_dtype=dtype, seed=SEED, **PATHS[path][1])
    return suite, entry


def _parallel_facade(out_dir):
    r"""(i): the facade's runs in a group of one over NCCL, then the same runs
    without a group; checks launch counts and the f32 runs' parameters."""
    import torch
    from vp_suite_tpu_torch.parallel import initialize_multihost, make_mesh
    from vp_suite_tpu_torch.parallel.mesh import all_reduce_gradients
    rank, world = initialize_multihost()
    check((rank, world) == (0, 1) and torch.distributed.get_backend() == "nccl",
          f"(i): joined rank {rank} of {world} over {torch.distributed.get_backend()}")
    run_kw = dict(steps_per_epoch=PAR_STEPS, context_frames=CTX, pred_frames=PRED,
                  no_vis=True, no_wandb=True)
    fps, params = {}, {}
    for grouped in (True, False):
        tag = "grouped" if grouped else "ungrouped"
        kw = dict(multihost=True) if grouped else {}
        for path, fsdp, backend in PAR_RUNS:
            suite, entry = _par_suite(path, torch.bfloat16, B)
            torch.cuda.synchronize()
            counters = reset_counts()
            suite.train(batch_size=B, out_dir=str(out_dir / f"i_{tag}_{path}"), fsdp=fsdp,
                        ckpt_backend=backend, epochs=2, **kw, **run_kw)
            torch.cuda.synchronize()
            launches = read_counts(counters)
            want = want_suite_launches(path, 2, PAR_STEPS)
            check(launches == want, f"(i) {tag} {path}: train launched {launches}, not {want}")
            fps[(tag, path)] = entry.train_epoch_fps[-1]
            written = out_dir / f"i_{tag}_{path}" / "final_model"
            check((written / ("orbax_state" if backend == "orbax" else "checkpoint.pt")).exists(),
                  f"(i) {tag} {path}: no {backend} checkpoint in {written}")
            print(f"[parallel] (i) {tag} {path} bf16 b={B} {CTX}->{PRED}, fsdp={fsdp}, "
                  f"ckpt_backend={backend}: launches "
                  + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
                  + f" (as wanted); {entry.train_epoch_fps[-1]:.1f} frames/s", flush=True)
            if grouped:   # the step's one collective, alone
                grads = [p for p in entry.model.parameters() if p.grad is not None]
                mesh = make_mesh(0, "data", "cuda")
                ms = cuda_ms(lambda: all_reduce_gradients(grads, mesh))
                mb = sum(p.grad.numel() * p.grad.element_size() for p in grads) / 2 ** 20
                print(f"[parallel] (i) {path}: the step's all-reduce of its {len(grads)} "
                      f"gradients ({mb:.1f} MiB, f32) over NCCL in a group of one: {ms:.3f} ms",
                      flush=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        for path, fsdp, backend in PAR_RUNS:
            suite, entry = _par_suite(path, torch.float32, PAR_B)
            suite.train(batch_size=PAR_B, out_dir=str(out_dir / f"i_{tag}_{path}_f32"),
                        fsdp=fsdp, ckpt_backend=backend, epochs=1, **kw, **run_kw)
            params[(tag, path)] = {k: v.detach().clone()
                                   for k, v in entry.model.named_parameters()}
        torch.backends.cudnn.deterministic = False
        if grouped:
            _mesh_graphs()
            torch.distributed.destroy_process_group()
    for path, _, _ in PAR_RUNS:
        a, b = params[("grouped", path)], params[("ungrouped", path)]
        rel = max(((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30)).item()
                  for k in b)
        print(f"[parallel] (i) {path}: the second epoch's train_epoch_fps (compiled steps, "
              f"replays) in a group of one (NCCL) {fps[('grouped', path)]:.1f} against "
              f"{fps[('ungrouped', path)]:.1f} without a group, on {nvidia_smi()}; f32 "
              f"b={PAR_B} parameters after {PAR_STEPS} Adam steps, largest "
              f"relative difference from the run without a group {rel:.3g} (limit {PAR_REL})",
              flush=True)
        check(rel <= PAR_REL, f"(i) {path}: the f32 run in a group of one parts from the run "
                              f"without a group by {rel:.3g}")


#: the compiled steps on a data mesh in the world of one over NCCL
#: (``_mesh_graphs``): the cases as (tag, path, FSDP, accum_steps), the f32 b=2
#: steps of each (an eager call, the capture, replays), and the bf16 b=B
#: replays timed with a mesh and without one
MESH_CASES = (("a", "per_step", False, 1), ("b FSDP", "fused_scan", True, 1),
              ("b FSDP accum 2", "fused_scan", True, 2), ("c", "trajgru", False, 1))
MESH_STEPS = 4
MESH_TIMED = 5
#: the collectives whose calls ``_mesh_graphs`` counts (the data all-reduce;
#: FSDP2's all-gather and reduce-scatter, which it skips in a world of one)
MESH_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")


def _counting_collectives(seen):
    r"""Counts each call of :data:`MESH_COLLECTIVES` into ``seen`` by
    ``(name, whether the calling stream was capturing)``; returns the undo."""
    import torch
    import torch.distributed as dist
    real = {n: getattr(dist, n) for n in MESH_COLLECTIVES}

    def counted(name):
        def call(*args, **kwargs):
            key = (name, torch.cuda.is_current_stream_capturing())
            seen[key] = seen.get(key, 0) + 1
            return real[name](*args, **kwargs)
        return call
    for n in real:
        setattr(dist, n, counted(n))
    return lambda: [setattr(dist, n, f) for n, f in real.items()]


def _graph_order(fn, early, late=("nccl", "onerank")):
    r"""Captures ``fn`` once more into a graph kept for its debug dump and
    reads the dump's nodes: ``(nodes, NCCL nodes, after, before)``, the count
    of its nodes, of those whose label holds one of ``late``, and whether each
    of those is reached from every node whose label holds ``early`` (the
    backward's kernel) and reaches every optimizer kernel; None where the
    dump fails."""
    import os
    import re
    import tempfile
    import torch
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    fd, path = tempfile.mkstemp(suffix=".dot", dir=ROOT / "vp-suite-data" / "chip_smoke")
    os.close(fd)
    try:
        graph.debug_dump(path)
        text = Path(path).read_text()
    finally:
        os.unlink(path)
    del graph
    node = r'"?((?:\w+_)?node_\d+)"?'
    labels = {m.group(1): m.group(2) for m in
              re.finditer(node + r'\s*\[[^\]]*?label="((?:[^"\\]|\\.)*)"', text)}
    if not labels:
        print(f"[parallel] (iii) the debug dump, {len(text)} characters, begins {text[:400]!r}")
        return None
    succ = {}
    for a, b in re.findall(node + r'\s*->\s*' + node, text):
        succ.setdefault(a, set()).add(b)

    def reached(a):
        seen, todo = set(), [a]
        while todo:
            for y in succ.get(todo.pop(), ()):
                if y not in seen:
                    seen.add(y)
                    todo.append(y)
        return seen
    lates = [n for n, lab in labels.items() if any(k in lab.lower() for k in late)]
    earlies = [n for n, lab in labels.items() if early in lab]
    optim = [n for n, lab in labels.items() if re.search(r"adam|sgd", lab, re.I)]
    after = all(n in reached(e) for e in earlies for n in lates)
    before = all(o in reached(n) for n in lates for o in optim)
    return len(labels), len(lates), after, before


def _mesh_model(path, fsdp, dtype=None):
    import torch
    model = _tp_model(path)
    if dtype is not None:
        model.compute_dtype = dtype
    if fsdp:   # FSDP2 over the mesh of one, which shard_params_fsdp leaves whole
        from torch.distributed.fsdp import fully_shard
        from vp_suite_tpu_torch.parallel import make_mesh
        small = {p for p in model.parameters() if p.numel() < 4096}
        fully_shard(model, mesh=make_mesh(0, "data", "cuda"), ignored_params=small)
    return model


def _local(p):
    from torch.distributed.tensor import DTensor
    return (p.to_local() if isinstance(p, DTensor) else p).detach()


def _mesh_graphs():
    r"""In the world of one over NCCL: ``make_train_step``, ``make_eval_step``
    and ``make_predict_fn`` with ``mesh=make_mesh(0, "data", "cuda")`` and
    ``use_jit=True`` on (a), on (b) under FSDP2 (``fully_shard`` over the
    mesh; ``accum_steps`` 1 and 2) and on (c), each against the same builder
    with ``use_jit=False`` on the same mesh, f32 at b=2 under cuDNN's
    deterministic algorithms: SGD (Adam under FSDP2: SGD over its DTensors
    has no form with a tensor rate, so its step refuses ``use_jit``), the
    parameters bit-identical after MESH_STEPS steps on (a) and (b), within
    the SGD gate as ``(p0 - p1) / lr`` on (c) (float atomics); the launches of
    the eager call and of the capture, none from the host in a replay; the
    replays under ``set_sync_debug_mode("error")``; the collectives called in
    the eager call and again, while capturing, in the capture, none in a
    replay; the profiler's kernels of one replay (the port's, and NCCL's by
    name); the order of NCCL's nodes in a graph of the step (its debug
    dump); then eval and predict graphed against eager, and two more train
    steps. Last, the bf16 b=B Adam step of (a) and (b) graphed on the mesh
    beside the graphed step without one (median host time of MESH_TIMED
    replays, ending in a read of the loss)."""
    import torch
    from vp_suite_tpu_torch.parallel import make_mesh
    from vp_suite_tpu_torch.training.loop import (make_eval_step, make_predict_fn,
                                                 make_train_step)
    from vp_suite_tpu_torch.training.train_state import create_train_state
    t0 = time.time()
    mesh = make_mesh(0, "data", "cuda")
    run = {"context_frames": CTX, "pred_frames": PRED}
    small = {"frames": _par_frames()[:2].cuda()}
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False
    print(f"[parallel] (iii) compiled steps on make_mesh(0, 'data', 'cuda') over "
          f"{torch.distributed.get_backend()} in a world of one, f32 b=2 against use_jit=False "
          f"on the same mesh, on {nvidia_smi()}", flush=True)
    backward = {"per_step": "_convlstm_gate_bwd", "fused_scan": "scan_bwd_",
                "trajgru": "warp_bwd_kernel"}
    for tag, path, fsdp, k in MESH_CASES:
        models = [_mesh_model(path, fsdp) for _ in range(2)]
        optimizer = "adam" if fsdp else "sgd"
        states = [create_train_state(m, lr=GRAPH_LR, optimizer=optimizer) for m in models]
        steps = [make_train_step(m, run, accum_steps=k, mesh=mesh, use_jit=j == 1)
                 for j, m in enumerate(models)]
        p0 = [_local(p).clone() for p in models[0].parameters()]
        want = {key: k * v for key, v in WANT_TRAIN_LAUNCHES[path].items()}
        counts, calls, losses = [], [], []
        for n in range(MESH_STEPS):
            _, eager = steps[0](states[0], small)
            torch.cuda.synchronize()
            seen = {}
            undo = _counting_collectives(seen)
            counters = reset_counts()
            torch.cuda.set_sync_debug_mode("error" if n >= 2 else 0)
            try:
                _, got = steps[1](states[1], small)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                undo()
            torch.cuda.synchronize()
            counts.append(read_counts(counters))
            calls.append(seen)
            losses.append((float(got["total"]), float(eager["total"])))
            # pinned host memory taken and given back between replays: a graph
            # node that read a freed pinned buffer would see it reused
            for _ in range(4):
                torch.empty(1 << 22, dtype=torch.uint8, pin_memory=True).cuda(non_blocking=True)
        check(counts[0] == want and counts[1] == want
              and all(c == _launches() for c in counts[2:]),
              f"(iii) {tag}: the eager call, the capture and the replays launched {counts}, not "
              f"{want}, {want} and none")
        # the eager call's one more all-reduce: the check that the processes
        # agree on the parameters without a gradient, which reads back
        eager_calls = {n: c for (n, capturing), c in calls[0].items() if not capturing}
        captured = {n: c for (n, capturing), c in calls[1].items() if capturing}
        check(captured.get("all_reduce", 0) >= 1 and len(calls[1]) == len(captured)
              and captured == {**eager_calls, "all_reduce": eager_calls.get("all_reduce") - 1}
              and not any(calls[2:]),
              f"(iii) {tag}: collectives called {calls} (eager, capture, replays)")
        same = sum(torch.equal(_local(a), _local(b))
                   for a, b in zip(models[0].parameters(), models[1].parameters()))
        deltas = [{i: (a - _local(p)) / GRAPH_LR
                   for i, (a, p) in enumerate(zip(p0, m.parameters()))} for m in models]
        worst = _delta_excess(deltas[1], deltas[0])
        exact = path != "trajgru"
        print(f"[parallel] (iii) {tag} f32 b=2 {optimizer}{', FSDP2' if fsdp else ''}, accum_steps "
              f"{k}: launches in the eager call "
              + ", ".join(f"{key} {v}" for key, v in counts[0].items() if v) + ", in the capture "
              + ", ".join(f"{key} {v}" for key, v in counts[1].items() if v)
              + f", from the host in each replay {[sum(c.values()) for c in counts[2:]]}; "
              f"collectives called in the eager call {eager_calls}, while capturing {captured}, "
              f"in the replays {calls[2:]}; losses (graphed, eager) "
              + ", ".join(f"{g:.9g}/{e:.9g}" for g, e in losses)
              + f"; after {MESH_STEPS} steps {same} of {len(p0)} parameters bit-identical, "
              f"(p0-p1)/lr max(|diff| - rtol*|eager|) {worst[0]:.3g}", flush=True)
        if exact:
            check(same == len(p0) and all(g == e for g, e in losses),
                  f"(iii) {tag}: the graphed mesh step is not bit-identical to the eager one")
        check(worst[0] <= STEP_TOL, f"(iii) {tag}: the graphed mesh step parts from the eager one")
        kernels = {}
        from torch.profiler import ProfilerActivity, profile as torch_profile
        steps[0](states[0], small)   # the eager model keeps step with the profiled replay
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            steps[1](states[1], small)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels[e.key] = e.count
        nccl = {key[:80]: c for key, c in kernels.items()
                if "nccl" in key.lower() or "onerank" in key.lower()}
        seen = {name: sum(c for key, c in kernels.items() if name in key)
                for name in by_name(want)}
        print(f"[parallel] (iii) {tag}: the profiler's kernels of one replay: "
              + ", ".join(f"{key} {v}" for key, v in seen.items() if v)
              + "; NCCL's " + str(nccl or "none (NCCL records no node for an in-place "
                                          "all-reduce of one rank)")
              + f"; {sum(kernels.values())} launches of {len(kernels)} kernels", flush=True)
        check(all(seen[key] <= v for key, v in by_name(want).items())
              and sum(seen.values()) > 0,
              f"(iii) {tag}: the profiler saw {seen} in one replay")
        order = _graph_order(lambda: steps[1].compiled.fn(states[1], states[1].generator, small,
                                                          {}), backward[path])
        print(f"[parallel] (iii) {tag}: a graph of the step (debug dump): "
              + ("not measured (no nodes in the dump)" if order is None else
                 f"{order[0]} nodes, none of them NCCL's (nothing to order against the "
                 f"backward's kernels in a world of one)" if not order[1] else
                 f"{order[0]} nodes, {order[1]} of NCCL, each after every "
                 f"{backward[path]} node: {order[2]}, before every optimizer node: {order[3]}"),
              flush=True)
        if order is not None:
            check(order[2] and order[3], f"(iii) {tag}: an NCCL node is not ordered after the "
                                         f"backward and before the optimizer")
        for make in (make_eval_step, make_predict_fn):
            fns = [make(m, run, mesh=mesh, use_jit=j == 1) for j, m in enumerate(models)]
            diffs, launched = [], []
            for n in range(3):
                args = (small,) if make is make_predict_fn else (None, small)
                want_out = fns[0](*args)
                torch.cuda.synchronize()
                counters = reset_counts()
                torch.cuda.set_sync_debug_mode("error" if n == 2 else 0)
                try:
                    got = fns[1](*args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                launched.append(sum(read_counts(counters).values()))
                a, b = (got["total"], want_out["total"]) if make is make_eval_step else \
                    (got[0], want_out[0])
                diffs.append((a - b).abs().max().item())
            limit = 0.0 if exact else PREDICT_ATOL_F32 * max(1.0, b.abs().max().item())
            print(f"[parallel] (iii) {tag} {make.__name__} on the mesh, graphed (eager call, "
                  f"capture, replay) against eager: max |diff| {diffs} (limit {limit:.3g}); "
                  f"launches {launched}", flush=True)
            check(max(diffs) <= limit and launched[2] == 0 and launched[0] == launched[1] > 0,
                  f"(iii) {tag}: the graphed {make.__name__} on the mesh parts from the eager one")
        for _ in range(2):
            for step, st in zip(steps, states):
                step(st, small)
        same = sum(torch.equal(_local(a), _local(b))
                   for a, b in zip(models[0].parameters(), models[1].parameters()))
        print(f"[parallel] (iii) {tag}: after eval, predict and 2 more steps {same} of {len(p0)} "
              f"parameters bit-identical", flush=True)
        if exact:
            check(same == len(p0), f"(iii) {tag}: the steps after eval and predict part")
        del models, states, steps
        torch.cuda.empty_cache()
    cudnn.deterministic = False

    frames = torch.rand((B, CTX + PRED, IMG[1], IMG[2], IMG[0]), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
    for path in ("per_step", "fused_scan"):
        ms = {}
        for where in ("mesh", "no mesh", "no mesh", "mesh"):
            model = _mesh_model(path, False, torch.bfloat16)
            state = create_train_state(model, lr=LR, seed=SEED)
            step = make_train_step(model, run, mesh=mesh if where == "mesh" else None)
            ms.setdefault(where, []).append(
                _time_step(step, state, {"frames": frames}, n=MESH_TIMED, warmup=3)[0])
            del model, state, step
            torch.cuda.empty_cache()
        print(f"[parallel] (iii) {path} bf16 b={B} Adam train step graphed, median of "
              f"{MESH_TIMED} replays: on the mesh " + " / ".join(f"{t:.2f}" for t in ms["mesh"])
              + " ms, without a mesh " + " / ".join(f"{t:.2f}" for t in ms["no mesh"])
              + f" ms (mesh, none, none, mesh), on {nvidia_smi()}", flush=True)
    print(f"[parallel] (iii) took {time.time() - t0:.1f} s", flush=True)


def _parallel_pair(out_dir):
    r"""One process of (ii): an f32 SGD step of each path on its half of the
    b=PAR_B batch (the fused path under FSDP), its launches, and the fused
    path's sharded checkpoint; writes ``pair_{rank}.pt``."""
    import torch
    from vp_suite_tpu_torch.checkpoint.orbax_backend import save_checkpoint_orbax
    from vp_suite_tpu_torch.models import build_model
    from vp_suite_tpu_torch.parallel import make_mesh, shard_batch, shard_params, shard_params_fsdp
    from vp_suite_tpu_torch.parallel.mesh import is_fsdp
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    from torch.distributed.tensor import DTensor
    rank = torch.distributed.get_rank()
    mesh = make_mesh(0, "data", "cuda")
    run_config = {"context_frames": CTX, "pred_frames": PRED}
    batch = shard_batch({"frames": _par_frames().cuda()}, mesh)
    out = {}
    for path, (model_id, cfg) in PATHS.items():
        if path == "trajgru":
            continue
        model = shard_params(build_model(model_id, SEED, "cuda", **_par_kwargs(), **cfg), mesh)
        if path == "fused_scan":
            shard_params_fsdp(model, mesh)
        state = create_train_state(model, lr=PAR_LR, optimizer="sgd")
        step = make_train_step(model, run_config, mesh=mesh, use_jit=False)
        torch.cuda.synchronize()
        counters = reset_counts()
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts(counters).items() if v}
        # each process's own rows of the sharded parameters (FSDP2's dim-0 chunks):
        # gathering them whole (DTensor.full_tensor) crashes gloo on CUDA tensors
        out[path] = {"loss": float(metrics["total"]), "launches": launches, "fsdp": is_fsdp(model),
                     "sharded": [k for k, v in model.named_parameters() if isinstance(v, DTensor)],
                     "params": {k: (v.to_local() if isinstance(v, DTensor) else v).detach().cpu()
                                for k, v in model.named_parameters()}}
        print(f"[parallel] (ii) process {rank} {path}: loss {out[path]['loss']:.6f}, launches "
              f"{launches}, FSDP {is_fsdp(model)}", flush=True)
        if path == "fused_scan":
            save_checkpoint_orbax(out_dir / "pair_ckpt", state, model_id, model.config, run_config)
    torch.save(out, out_dir / f"pair_{rank}.pt")


#: the tensor-parallel phase (``drive_tensor_parallel``): its worlds as
#: (task, processes, mesh), and the timed steps of (t2) after its counted one
TP_WORLDS = (("tp1", 1, {"data": 1, "sp": 1, "tp": 1}), ("tp2", 2, {"data": 1, "tp": 2}),
             ("tp4", 4, {"data": 2, "sp": 1, "tp": 2}))
TP_TIMED = 1
#: (t1)'s compiled calls of each step: the eager call, the capture, a replay
TP1_CALLS = 3
#: (t2)'s f32 predict against one process's
TP_PREDICT_ATOL = 1e-4


def drive_tensor_parallel(card):
    r"""Tensor parallelism in child processes of this script
    (:func:`parallel_worker`): (t1) a world of one over NCCL on a 1x1x1
    data x sp x tp mesh and (t3) four processes on the one card over gloo on
    a 2x1x2 mesh under
    ``shard_params_tp_fsdp``, started together; then (t2) two processes over
    gloo on ``{"data": 1, "tp": 2}`` alone, since it times its steps; then,
    here, the one-process steps and predictions that (t2) and (t3) are held
    against. Deletes its files under ``vp-suite-data/chip_smoke/tp``."""
    import shutil
    import torch
    t_phase = time.time()
    out_root = ROOT / "vp-suite-data" / "chip_smoke" / "tp"
    shutil.rmtree(out_root, ignore_errors=True)
    out_root.mkdir(parents=True)
    print(f"[tp] {card}")
    try:
        worlds = {task: _start_world(task, n, out_root) for task, n, _ in TP_WORLDS
                  if task != "tp2"}
        for task, world in worlds.items():
            late, rcs = _end_world(*world)
            check(not late and all(rc == 0 for rc in rcs), f"{task}: exit codes {rcs}, late {late}")
        _run_world("tp2", 2, out_root)

        frames = _par_frames().cuda()
        ranks = [torch.load(out_root / f"tp2_{r}.pt", weights_only=False) for r in range(2)]
        ranks4 = [torch.load(out_root / f"tp4_{r}.pt", weights_only=False) for r in range(4)]
        for path in ("per_step", "fused_scan"):
            model, p0, loss, one_ms = _tp_one_process_step(path, frames)
            got = ranks[0][path]
            check(all(torch.equal(v, ranks[1][path]["params"][k])
                      for k, v in got["params"].items()),
                  f"(t2) {path}: the two processes' gathered parameters differ")
            worst, where = _step_excess(p0, model, got["params"])
            ok = worst <= STEP_TOL and abs(got["loss"] - loss) <= 1e-4 * abs(loss)
            print(f"[tp] (t2) {path} f32 SGD step of two tp processes (gloo, b={PAR_B} each) "
                  f"against one process: loss {got['loss']:.6f} vs {loss:.6f}; (p0-p1)/lr: "
                  f"max(|diff| - rtol*|one|) {worst:.3g} at {where} (rtol {STEP_TOL}, must stay "
                  f"<= atol {STEP_TOL}); {got['sharded']} leaves tp-sharded, each process's "
                  f"shard its own slice: {got['shards_exact']}: {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"(t2) {path}: the tp step disagrees with the one-process step")
            check(all(r[path]["shards_exact"] for r in ranks),
                  f"(t2) {path}: a process holds another slice than its own")
            want = _tp_one_process_predict(path, frames)
            diff = (got["preds"].cuda() - want).abs().max().item()
            print(f"[tp] (t2) {path} f32 predict of two tp processes against one process: max "
                  f"|diff| {diff:.3g} (limit {TP_PREDICT_ATOL})", flush=True)
            check(diff <= TP_PREDICT_ATOL, f"(t2) {path}: predict parts from one process's")
            print(f"[tp] (t2) {path} f32 b={PAR_B} train step ({TP_TIMED} timed): "
                  f"{_ms(got['step_ms'])} / {_ms(ranks[1][path]['step_ms'])} ms in the two tp "
                  f"processes on the one card (gloo) against {_ms(one_ms)} ms in one process "
                  f"(tp=1); the step's {got['collectives']} tp collectives "
                  f"({got['collective_mib']:.1f} MiB) {got['collective_ms']:.1f} ms (CUDA events "
                  f"around each alone, summed); two processes on one card measure no scaling",
                  flush=True)
            if path == "fused_scan":
                params = _tp4_params(ranks4)
                worst, where = _step_excess(p0, model, params)
                ok = worst <= STEP_TOL and abs(ranks4[0]["loss"] - loss) <= 1e-4 * abs(loss)
                print(f"[tp] (t3) fused_scan f32 SGD step of four processes (gloo, data 2 x tp "
                      f"2, shard_params_tp_fsdp, b={PAR_B // 2} each) against one process: loss "
                      f"{ranks4[0]['loss']:.6f} vs {loss:.6f}; (p0-p1)/lr: max(|diff| - "
                      f"rtol*|one|) {worst:.3g} at {where}; {ranks4[0]['two_d']} leaves 2-D: "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, "(t3) the 2-D step disagrees with the one-process step")
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    print(f"[tp] the phase took {time.time() - t_phase:.1f} s", flush=True)


def _tp_model(path):
    from vp_suite_tpu_torch.models import build_model
    model_id, cfg = PATHS[path]
    return build_model(model_id, SEED, "cuda", **_par_kwargs(), **cfg)


def _tp_one_process_step(path, frames):
    r"""``(model after, its parameters before, loss, [step ms])`` of the
    one-process f32 SGD step at b=PAR_B (then TP_TIMED more, timed)."""
    import torch
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    model = _tp_model(path)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = create_train_state(model, lr=PAR_LR, optimizer="sgd")
    step = make_train_step(model, {"context_frames": CTX, "pred_frames": PRED}, use_jit=False)
    _, metrics = step(state, {"frames": frames})
    loss = float(metrics["total"])
    after = {k: v.detach().clone() for k, v in model.named_parameters()}
    _, _, times = _time_step(step, state, {"frames": frames}, n=TP_TIMED, warmup=0)
    with torch.no_grad():
        for k, v in model.named_parameters():
            v.copy_(after[k])
    return model, p0, loss, [t * 1e3 for t in times]


def _ms(times):
    return ", ".join(f"{t:.1f}" for t in times)


def _tp_one_process_predict(path, frames):
    from vp_suite_tpu_torch.training.loop import make_predict_fn
    return make_predict_fn(_tp_model(path), {"context_frames": CTX, "pred_frames": PRED})(
        {"frames": frames})[0]


def _step_excess(p0, model, got):
    r"""The SGD gate: ``max(|(p0 - p1)/lr - (p0 - p1')/lr| - STEP_TOL
    |(p0 - p1')/lr|)`` over ``got``'s parameters against ``model``'s; with
    its parameter's name."""
    worst, where = 0.0, ""
    for k, v in model.named_parameters():
        want = (p0[k] - v.detach()) / PAR_LR
        mine = (p0[k] - got[k].to(v.device)) / PAR_LR
        excess = ((mine - want).abs() - STEP_TOL * want.abs()).max().item()
        if excess > worst or not where:
            worst, where = excess, k
    return worst, where


def _tp4_params(ranks4):
    r"""(t3)'s parameters whole: each tp-gathered FSDP shard of data
    coordinates 0 and 1 (processes 0 and 2) joined along FSDP's dimension."""
    import torch
    out = {}
    for k, (t, dim) in ranks4[0]["params"].items():
        out[k] = t if dim is None else torch.cat([t, ranks4[2]["params"][k][0]], dim)
    return out


def _tp_world_of_one(out_dir):
    r"""(t1): one process over NCCL on a 1x1x1 mesh: each path's f32 SGD step
    and predict, compiled (an eager call, the capture, a replay), with exact
    launch counts, bit-identical to the same without a group (cuDNN's
    deterministic algorithms)."""
    import torch
    from vp_suite_tpu_torch.parallel import (initialize_multihost, make_mesh_nd, shard_params,
                                             shard_params_tp)
    from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    rank, world = initialize_multihost()
    check((rank, world) == (0, 1) and torch.distributed.get_backend() == "nccl",
          f"(t1): joined rank {rank} of {world} over {torch.distributed.get_backend()}")
    mesh = make_mesh_nd(TP_WORLDS[0][2], "cuda")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    run = {"context_frames": CTX, "pred_frames": PRED}
    frames = _par_frames().cuda()
    for path in ("per_step", "fused_scan"):
        params = {}
        for grouped in (True, False):
            model = _tp_model(path)
            if grouped:
                shard_params_tp(shard_params(model, mesh), mesh)
            state = create_train_state(model, lr=PAR_LR, optimizer="sgd")
            step = make_train_step(model, run, mesh=mesh if grouped else None)
            predict_fn = make_predict_fn(model, run, mesh=mesh if grouped else None)
            torch.cuda.synchronize()
            counters = reset_counts()
            for _ in range(TP1_CALLS):
                step(state, {"frames": frames})
            torch.cuda.synchronize()
            train = read_counts(counters)
            counters = reset_counts()
            for _ in range(TP1_CALLS):
                predict_fn({"frames": frames})
            torch.cuda.synchronize()
            predict = read_counts(counters)
            n = compiled_calls(TP1_CALLS)
            check(train == {k: n * v for k, v in WANT_TRAIN_LAUNCHES[path].items()}
                  and predict == {k: n * v for k, v in WANT_PREDICT_LAUNCHES[path].items()},
                  f"(t1) {path}: {TP1_CALLS} compiled steps launched {train}, predicts {predict}")
            params[grouped] = {k: v.detach().clone() for k, v in model.named_parameters()}
        same = all(torch.equal(v, params[False][k]) for k, v in params[True].items())
        print(f"[tp] (t1) {path} in a world of one over NCCL on a 1x1x1 data x sp x tp mesh, "
              f"{TP1_CALLS} compiled calls: step launches "
              + ", ".join(f"{k} {v}" for k, v in train.items() if v)
              + ", predict " + ", ".join(f"{k} {v}" for k, v in predict.items() if v)
              + f" (as wanted); f32 SGD steps bit-identical to the run without a group: {same}",
              flush=True)
        check(same, f"(t1) {path}: the step in a world of one parts from the step without one")
    torch.distributed.destroy_process_group()


def _tp_pair(out_dir):
    r"""(t2): one of two processes on ``{"data": 1, "tp": 2}`` over gloo:
    each path's f32 predict, then its SGD step at b=PAR_B with its launches
    and its tp collectives and TP_TIMED more steps timed; writes
    ``tp2_{rank}.pt`` with the parameters whole after the first step."""
    import torch
    from vp_suite_tpu_torch.parallel import make_mesh_nd, shard_params_tp
    from vp_suite_tpu_torch.parallel.tensor import all_gather, record, sharded_params, whole
    from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    rank = torch.distributed.get_rank()
    mesh = make_mesh_nd(TP_WORLDS[1][2], "cuda")
    run = {"context_frames": CTX, "pred_frames": PRED}
    batch = {"frames": _par_frames().cuda()}
    out = {}
    for path in ("per_step", "fused_scan"):
        full = _tp_model(path).state_dict()
        model = shard_params_tp(_tp_model(path), mesh)
        specs = sharded_params(model)
        exact = all(torch.equal(v, full[k].narrow(specs[k].dim, specs[k].rank * specs[k].local,
                                                  specs[k].local)) if k in specs
                    else torch.equal(v, full[k]) for k, v in model.named_parameters())
        counters = reset_counts()
        preds, _ = make_predict_fn(model, run, use_jit=False)(batch)
        torch.cuda.synchronize()
        predict = read_counts(counters)
        check(predict == WANT_PREDICT_LAUNCHES[path],
              f"(t2) {path}: process {rank}'s predict launched {predict}")
        state = create_train_state(model, lr=PAR_LR, optimizer="sgd")
        step = make_train_step(model, run, mesh=mesh, use_jit=False)
        counters = reset_counts()
        with record() as log:
            _, metrics = step(state, batch)
        torch.cuda.synchronize()
        launches = read_counts(counters)
        check(launches == WANT_TRAIN_LAUNCHES[path],
              f"(t2) {path}: process {rank}'s step launched {launches}")
        params = {k: whole(k, v, specs).detach().to("cpu", copy=True)
                  for k, v in model.named_parameters()}
        _, _, times = _time_step(step, state, batch, n=TP_TIMED, warmup=0)
        step_ms = [t * 1e3 for t in times]
        # each collective of the step alone, at its shape, on the tp group
        group = mesh.get_group("tp")
        calls = {}
        for kind, _, shape, dtype in log:
            if kind in ("gather", "all_reduce"):
                calls[(kind, shape, dtype)] = calls.get((kind, shape, dtype), 0) + 1
        ms = mib = 0.0
        for (kind, shape, dtype), n in sorted(calls.items(), key=str):
            x = torch.ones(shape, dtype=dtype, device="cuda")
            if kind == "gather":
                part = x[:shape[0] // 2]
                one = cuda_ms(lambda: all_gather(part, 0, 2, group), warmup=0, iters=1)
            else:
                one = cuda_ms(lambda: torch.distributed.all_reduce(x, group=group), warmup=0,
                              iters=1)
            ms += n * one
            mib += n * x.numel() * x.element_size() / 2 ** 20
        print(f"[tp] (t2) process {rank} {path}: launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items() if v) + ", predict "
              + ", ".join(f"{k} {v}" for k, v in predict.items() if v)
              + f"; {sum(calls.values())} tp collectives a step, {ms:.1f} ms; steps "
              f"{_ms(step_ms)} ms",
              flush=True)
        out[path] = {"loss": float(metrics["total"]), "params": params, "preds": preds.cpu(),
                     "sharded": len(specs), "shards_exact": exact, "step_ms": step_ms,
                     "collectives": sum(calls.values()), "collective_ms": ms,
                     "collective_mib": mib}
    torch.save(out, out_dir / f"tp2_{rank}.pt")


def _tp_2d(out_dir):
    r"""(t3): one of four processes on a 2x1x2 data x sp x tp mesh over gloo:
    the fused path's f32 SGD step under ``shard_params_tp_fsdp`` on its half
    of the b=PAR_B batch, with its launches; writes ``tp4_{rank}.pt`` with
    each parameter's FSDP shard gathered over tp and FSDP's dimension
    (``DTensor.full_tensor`` crashes gloo on CUDA tensors)."""
    import torch
    from torch.distributed.tensor import DTensor
    from vp_suite_tpu_torch.parallel import (make_mesh_nd, shard_params_tp_fsdp,
                                             shard_video_batch)
    from vp_suite_tpu_torch.parallel.tensor import sharded_params, whole
    from vp_suite_tpu_torch.training.loop import make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    rank = torch.distributed.get_rank()
    mesh = make_mesh_nd(TP_WORLDS[2][2], "cuda")
    model = shard_params_tp_fsdp(_tp_model("fused_scan"), mesh)
    specs = sharded_params(model)
    state = create_train_state(model, lr=PAR_LR, optimizer="sgd")
    batch = shard_video_batch({"frames": _par_frames().cuda()}, mesh)
    torch.cuda.synchronize()
    counters = reset_counts()
    _, metrics = make_train_step(model, {"context_frames": CTX, "pred_frames": PRED},
                                 mesh=mesh, use_jit=False)(state, batch)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    check(launches == WANT_TRAIN_LAUNCHES["fused_scan"],
          f"(t3) process {rank}'s step launched {launches}")
    params, two_d = {}, 0
    for k, p in model.named_parameters():
        dim = p.placements[0].dim if isinstance(p, DTensor) else None
        two_d += dim is not None and k in specs
        params[k] = (whole(k, p.to_local() if dim is not None else p, specs).detach()
                     .to("cpu", copy=True), dim)
    print(f"[tp] (t3) process {rank}: loss {float(metrics['total']):.6f}, launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f", {two_d} leaves split over data and tp", flush=True)
    torch.save({"loss": float(metrics["total"]), "params": params, "two_d": two_d},
               out_dir / f"tp4_{rank}.pt")


#: the model-parallel phase (``drive_model_parallel``): one world of two
#: processes over gloo on the one card runs (s) EF-ConvLSTM on MP_SP_MESH,
#: (q) MinConvRNN (its defaults: hidden 64, two layers) on ``{"seq": 2}`` at
#: MP_MCR_FRAMES, (p) ``gpipe_apply`` on ``{"pp": 2}`` with the JAX package's
#: dry-run stage (a 3x3 conv of MP_PP_C channels + tanh; MP_PP_M microbatches of
#: MP_PP_MB) at 64x64
MP_SP_MESH = {"data": 1, "sp": 2}
MP_MCR_FRAMES = (6, 10)
MP_PP_C, MP_PP_M, MP_PP_MB = 4, 4, 2
#: (p) against the serial composition: the output (tanh, |y| <= 1) in f32, and
#: the gradients relative to the largest of each (sums over microbatches against
#: one sum over the batch)
MP_PP_ATOL = 1e-5
MP_PP_GRAD_REL = 1e-4


def drive_model_parallel(card):
    r"""Spatial, context and pipeline parallelism in child processes of this
    script (:func:`parallel_worker`, task ``mp2``): two processes on the one
    card over gloo run (s), (q) and (p) in turn; then, here, the one-process
    runs they are held against. Deletes its files under
    ``vp-suite-data/chip_smoke/mp``."""
    import shutil
    import torch
    t_phase = time.time()
    out_root = ROOT / "vp-suite-data" / "chip_smoke" / "mp"
    shutil.rmtree(out_root, ignore_errors=True)
    out_root.mkdir(parents=True)
    print(f"[mp] {card}")
    try:
        _run_world("mp2", 2, out_root)
        ranks = [torch.load(out_root / f"mp2_{r}.pt", weights_only=False) for r in range(2)]
        frames = _par_frames().cuda()
        for path in ("per_step", "fused_scan"):
            model, p0, loss, one_ms = _tp_one_process_step(path, frames)
            got = ranks[0][path]
            check(all(torch.equal(v, ranks[1][path]["params"][k])
                      for k, v in got["params"].items()),
                  f"(s) {path}: the two sp processes' parameters differ")
            worst, where = _step_excess(p0, model, got["params"])
            ok = worst <= STEP_TOL and abs(got["loss"] - loss) <= 1e-4 * abs(loss)
            print(f"[mp] (s) {path} f32 SGD step of two sp processes (gloo, {MP_SP_MESH}, b="
                  f"{PAR_B} and {IMG[1] // 2} of the {IMG[1]} image rows each) against one "
                  f"process: loss {got['loss']:.6f} vs {loss:.6f}; (p0-p1)/lr: max(|diff| - rtol*|one|) "
                  f"{worst:.3g} at {where} (rtol {STEP_TOL}, must stay <= atol {STEP_TOL}): "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"(s) {path}: the sp step disagrees with the one-process step")
            want = _tp_one_process_predict(path, frames)
            diff = max((r[path]["preds"].cuda() - want).abs().max().item() for r in ranks)
            print(f"[mp] (s) {path} f32 predict of two sp processes (whole frames on each) "
                  f"against one process: max |diff| {diff:.3g} (limit {TP_PREDICT_ATOL})",
                  flush=True)
            check(diff <= TP_PREDICT_ATOL, f"(s) {path}: predict parts from one process's")
            print(f"[mp] (s) {path} f32 b={PAR_B} train step: {got['step_ms']:.1f} / "
                  f"{ranks[1][path]['step_ms']:.1f} ms in the two sp processes on the one card "
                  f"(gloo) against {_ms(one_ms)} ms in one process; the step's "
                  f"{got['collectives']} spatial collectives ({got['collective_mib']:.1f} MiB: "
                  f"{got['kinds']}) {got['collective_ms']:.1f} ms (CUDA events around each "
                  f"alone, summed); two processes on one card measure no scaling", flush=True)

        # (q) MinConvRNN's context scan over seq against one process
        q_frames = _mp_mcr_frames().cuda()
        model, p0, loss, preds = _mp_mcr_one_process(q_frames)
        got = ranks[0]["mcr"]
        worst, where = _step_excess(p0, model, got["params"])
        diff = max((r["mcr"]["preds"].cuda() - preds).abs().max().item() for r in ranks)
        ok = worst <= STEP_TOL and abs(got["loss"] - loss) <= 1e-4 * abs(loss) \
            and diff <= TP_PREDICT_ATOL and got["gathers"] > 0
        print(f"[mp] (q) MinConvRNN hidden 64 at {IMG[1]}x{IMG[2]}, {MP_MCR_FRAMES[0]} -> "
              f"{MP_MCR_FRAMES[1]}, context scan over {{'seq': 2}} ({got['gathers']} "
              f"all-gathers a predict and step): f32 predict max |diff| {diff:.3g} (limit "
              f"{TP_PREDICT_ATOL}); SGD step loss {got['loss']:.6f} vs {loss:.6f}, (p0-p1)/lr "
              f"gate {worst:.3g} at {where}: {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, "(q) the context-sharded MinConvRNN disagrees with one process")

        # (p) gpipe_apply against the serial composition
        y, loss, dx, grads = _mp_pp_serial()
        for r, got in enumerate(ranks):
            got = got["pp"]
            check(got["grads"]["x"] is not None, f"(p) process {r}: the input has no gradient")
            y_diff = (got["y"].cuda().reshape(y.shape) - y).abs().max().item()
            rel = {k: ((got["grads"][k].cuda() - v).abs().max() / v.abs().max()).item()
                   for k, v in {**grads, "x": dx}.items()}
            ok = y_diff <= MP_PP_ATOL and max(rel.values()) <= MP_PP_GRAD_REL \
                and abs(got["loss"] - loss) <= 1e-5 * abs(loss)
            print(f"[mp] (p) process {r}: gpipe_apply of {MP_PP_M} microbatches of {MP_PP_MB} "
                  f"over {{'pp': 2}} (3x3 conv of {MP_PP_C} channels + tanh at {IMG[1]}x{IMG[2]}) "
                  f"against "
                  f"the serial stages: output max |diff| {y_diff:.3g} (limit {MP_PP_ATOL}); "
                  f"gradients relative to the largest "
                  + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
                  + f" (limit {MP_PP_GRAD_REL}): {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"(p) process {r}: the pipeline disagrees with the serial stages")
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    print(f"[mp] the phase took {time.time() - t_phase:.1f} s", flush=True)


def _mp_mcr_frames():
    import torch
    return torch.rand((PAR_B, sum(MP_MCR_FRAMES), IMG[1], IMG[2], IMG[0]),
                      generator=torch.Generator().manual_seed(SEED + 8))


def _mp_mcr_model(mesh=None):
    from vp_suite_tpu_torch.models import build_model
    return build_model("min-conv-rnn", SEED, "cuda", **_par_kwargs(),
                       **({} if mesh is None else {"context_mesh": mesh}))


def _mp_mcr_one_process(frames):
    r"""``(model after, its parameters before, loss, predictions)`` of
    MinConvRNN's one-process f32 predict and SGD step."""
    from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    run = dict(zip(("context_frames", "pred_frames"), MP_MCR_FRAMES))
    model = _mp_mcr_model()
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    preds = make_predict_fn(model, run)({"frames": frames})[0]
    state = create_train_state(model, lr=PAR_LR, optimizer="sgd")
    _, metrics = make_train_step(model, run)(state, {"frames": frames})
    return model, p0, float(metrics["total"]), preds


def _mp_pp_inputs():
    r"""``(per-stage parameters, x, target)`` of (p), on the card."""
    import torch
    g = torch.Generator().manual_seed(SEED + 9)
    c, b = MP_PP_C, MP_PP_M * MP_PP_MB
    params = [{"w": torch.randn(c, c, 3, 3, generator=g) * 0.3, "b": torch.randn(c, generator=g)
               * 0.1} for _ in range(2)]
    x = torch.rand(b, IMG[1], IMG[2], c, generator=g)
    tgt = torch.rand(b, IMG[1], IMG[2], c, generator=g)
    return [{k: v.cuda() for k, v in p.items()} for p in params], x.cuda(), tgt.cuda()


def _mp_pp_stage(params, x):
    import torch
    from vp_suite_tpu_torch.nn.functional import conv2d
    return torch.tanh(conv2d(x, params["w"], params["b"], 1, 1))


def _mp_pp_serial():
    r"""``(y, loss, dx, {leaf: stacked gradient})`` of (p)'s stages in turn on
    the whole batch, in this process."""
    import torch
    params, x, tgt = _mp_pp_inputs()
    for p in params:
        for v in p.values():
            v.requires_grad_(True)
    x.requires_grad_(True)
    y = x
    for p in params:
        y = _mp_pp_stage(p, y)
    loss = ((y - tgt) ** 2).mean()
    loss.backward()
    grads = {k: torch.stack([p[k].grad for p in params]) for k in ("w", "b")}
    return y.detach(), loss.item(), x.grad, grads


def _model_parallel_pair(out_dir):
    r"""One of the two processes of ``drive_model_parallel``: (s) each EF-ConvLSTM
    path's f32 predict and SGD step on MP_SP_MESH at b=PAR_B on this process's
    image rows, with their launches, the step's spatial collectives (each timed
    alone) and its time; (q) MinConvRNN's predict and SGD step with its context
    scan over ``{"seq": 2}``; (p) ``gpipe_apply`` over ``{"pp": 2}`` with the
    gradients; writes ``mp2_{rank}.pt``."""
    import torch
    import torch.distributed as dist
    from vp_suite_tpu_torch.parallel import (gpipe_apply, make_mesh_nd, microbatch,
                                             shard_video_batch, spatial_halo_convs,
                                             stack_stage_params)
    from vp_suite_tpu_torch.parallel import spatial
    from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
    from vp_suite_tpu_torch.training.train_state import create_train_state
    rank = dist.get_rank()
    run = {"context_frames": CTX, "pred_frames": PRED}
    out = {}

    # (s) EF-ConvLSTM on image slabs
    mesh = make_mesh_nd(MP_SP_MESH, "cuda")
    group = mesh.get_group("sp")
    batch = shard_video_batch({"frames": _par_frames().cuda()}, mesh)
    for path in ("per_step", "fused_scan"):
        model = _tp_model(path)
        counters = reset_counts()
        preds, _ = make_predict_fn(model, run, mesh=mesh, use_jit=False)(batch)
        torch.cuda.synchronize()
        predict = read_counts(counters)
        check(predict == WANT_PREDICT_LAUNCHES[path],
              f"(s) {path}: process {rank}'s predict launched {predict}")
        state = create_train_state(model, lr=PAR_LR, optimizer="sgd")
        with spatial_halo_convs(mesh):
            step = make_train_step(model, run, mesh=mesh, use_jit=False)
        torch.cuda.synchronize()
        counters = reset_counts()
        t0 = time.perf_counter()
        with spatial.record() as log:
            _, metrics = step(state, batch)
        loss = float(metrics["total"])   # waits for the card
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(counters)
        check(launches == WANT_TRAIN_LAUNCHES[path],
              f"(s) {path}: process {rank}'s step launched {launches}")
        calls = {}
        for key in log:
            calls[key] = calls.get(key, 0) + 1
        ms = mib = 0.0
        for (kind, shape, dtype), n in sorted(calls.items(), key=str):
            x = torch.ones(shape, dtype=dtype, device="cuda")
            if kind == "gather":
                part = x[:shape[0] // 2]
                one = cuda_ms(lambda: dist.all_gather_into_tensor(x, part, group=group),
                              warmup=0, iters=1)
            else:
                one = cuda_ms(lambda: dist.all_reduce(x, group=group), warmup=0, iters=1)
            ms += n * one
            mib += n * x.numel() * x.element_size() / 2 ** 20
        kinds = ", ".join(f"{sum(n for (k, _, _), n in calls.items() if k == kind)} {kind}"
                          for kind in ("gather", "all_reduce"))
        print(f"[mp] (s) process {rank} {path}: launches "
              + ", ".join(f"{k} {v}" for k, v in launches.items() if v) + ", predict "
              + ", ".join(f"{k} {v}" for k, v in predict.items() if v)
              + f"; {len(log)} spatial collectives a step ({kinds}), {mib:.1f} MiB, {ms:.1f} ms; "
              f"step {step_ms:.1f} ms", flush=True)
        out[path] = {"loss": loss, "preds": preds.cpu(), "step_ms": step_ms,
                     "params": {k: v.detach().to("cpu", copy=True)
                                for k, v in model.named_parameters()},
                     "collectives": len(log), "collective_ms": ms, "collective_mib": mib,
                     "kinds": kinds}

    # (q) MinConvRNN's context scan sharded over seq
    mesh = make_mesh_nd({"seq": 2}, "cuda")
    run_q = dict(zip(("context_frames", "pred_frames"), MP_MCR_FRAMES))
    frames = {"frames": _mp_mcr_frames().cuda()}
    model = _mp_mcr_model(mesh)
    gathers = [0]
    gather = dist.all_gather_into_tensor

    def counted(*a, **k):
        gathers[0] += 1
        return gather(*a, **k)
    dist.all_gather_into_tensor = counted
    try:
        counters = reset_counts()
        preds = make_predict_fn(model, run_q, use_jit=False)(frames)[0]
        state = create_train_state(model, lr=PAR_LR, optimizer="sgd")
        _, metrics = make_train_step(model, run_q, use_jit=False)(state, frames)
        torch.cuda.synchronize()
    finally:
        dist.all_gather_into_tensor = gather
    check(not any(read_counts(counters).values()), "(q) MinConvRNN launched a kernel")
    out["mcr"] = {"loss": float(metrics["total"]), "preds": preds.cpu(), "gathers": gathers[0],
                  "params": {k: v.detach().to("cpu", copy=True)
                             for k, v in model.named_parameters()}}

    # (p) the pipeline
    mesh = make_mesh_nd({"pp": 2}, "cuda")
    params, x, tgt = _mp_pp_inputs()
    stacked = stack_stage_params(params)
    for v in stacked.values():
        v.requires_grad_(True)
    x.requires_grad_(True)
    y = gpipe_apply(_mp_pp_stage, stacked, microbatch(x, MP_PP_M), mesh)
    loss = ((y.reshape(tgt.shape) - tgt) ** 2).mean()
    loss.backward()
    out["pp"] = {"y": y.detach().cpu(), "loss": loss.item(),
                 "grads": {**{k: v.grad.cpu() for k, v in stacked.items()},
                           "x": None if x.grad is None else x.grad.cpu()}}
    torch.save(out, out_dir / f"mp2_{rank}.pt")


def forward_ms(model, batch):
    r"""Median host time of the train step's forward and loss alone (grad mode
    on, so the forward saves what the backward needs; no backward)."""
    import torch
    from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
    from vp_suite_tpu_torch.training.loop import _apply_model
    losses = PredictionLossProvider({"losses_and_scales": {"mse": 1.0}})
    frames = batch["frames"]
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, _ = _apply_model(model, frames[:, :CTX], pred_frames=PRED, train=True)
        float(losses.get_losses(preds, frames[:, CTX:])[1].detach())   # waits for the card
        times.append(time.perf_counter() - t0)
        del preds
    return sorted(times[1:])[1] * 1e3


def time_kernels(serve, train, gate_inputs, scan_inputs, warp_inputs, rnd, errs):
    r"""Each kernel at the shapes its path gives it, beside its plain version,
    its bound and, where there is one, the one PyTorch call that computes the
    same function; returns the kernels' JSON entries."""
    import torch
    from vp_suite_tpu_torch.ops.cells import (convlstm_gate_backward,
                                              convlstm_gate_backward_reference,
                                              convlstm_gate_forward, convlstm_gate_reference)
    from vp_suite_tpu_torch.ops.convlstm import (convlstm_scan_backward,
                                                 convlstm_scan_backward_reference,
                                                 convlstm_scan_forward,
                                                 convlstm_scan_forward_reference)
    # K1 and K2: one launch per cell and step, in bf16. Device time from
    # CUDA-graph replay; "eager" is back-to-back launches from Python, which
    # the host's launch rate bounds at the small shapes.
    gate_launches = cell_launches(serve["suite"].models[list(PATHS).index("per_step")].model,
                                  lambda rnn: rnn.state_h)
    check(sum(gate_launches.values()) == serve["launches"]["per_step"]["K1"],
          f"K1 launch shapes {gate_launches} do not add up to "
          f"{serve['launches']['per_step']['K1']} launches")
    rows = {"K1": [], "K2": []}
    for (side, ch), steps in gate_launches.items():
        args = gate_inputs[(side, ch, torch.bfloat16)]
        for kid, fn, ref, a, bwd in (("K1", convlstm_gate_forward, convlstm_gate_reference,
                                      args[:5], False),
                                     ("K2", convlstm_gate_backward,
                                      convlstm_gate_backward_reference, args, True)):
            ms = graph_ms(lambda: fn(*a))
            eager = cuda_ms(lambda: fn(*a), warmup=10, iters=50)
            plain = graph_ms(lambda: ref(*a), iters=20)
            nbytes, ops = gate_cost(side, ch, 2, backward=bwd)
            bound, _ = bound_ms(nbytes, ops, F32_FLOPS)
            print(f"[time] {kid} {side}x{side}x{ch} bf16: {ms * 1e3:.1f} us/launch (eager "
                  f"{eager * 1e3:.1f} us, plain {plain * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
                  f"by bytes, {nbytes / 1e6:.1f} MB), {steps} launches/"
                  f"{'predict' if kid == 'K1' else 'train step'}")
            rows[kid].append((steps, ms, plain, nbytes, ops))
    k1, k2 = summed(rows["K1"], F32_FLOPS), summed(rows["K2"], F32_FLOPS)

    # K3 (predict, no residuals), K3s and K4 (train step): the fused path's six launches.
    rows = {"K3": [], "K3s": [], "K4": []}
    dt = torch.bfloat16
    for side, enc, steps, with_x in serve["scan_launches"]:
        args = scan_args(rnd, side, enc, steps, with_x, dt)
        for kid, save in (("K3", False), ("K3s", True)):
            ms = cuda_ms(lambda: convlstm_scan_forward(*args, seq_len=steps, save_gates=save),
                         warmup=2, iters=10)
            plain = cuda_ms(lambda: convlstm_scan_forward_reference(
                *args, seq_len=steps, save_gates=save), warmup=1, iters=3)
            nbytes, ops = scan_cost(side, enc, steps, with_x, 2, save_gates=save)
            rows[kid].append((1, ms, plain, nbytes, ops))
            report_scan(kid, side, enc, steps, with_x, ms, plain, nbytes, ops)
        bwd_args = scan_inputs[(side, enc, steps, with_x)]
        ms = cuda_ms(lambda: convlstm_scan_backward(*bwd_args), warmup=2, iters=10)
        plain = cuda_ms(lambda: convlstm_scan_backward_reference(*bwd_args), warmup=1, iters=3)
        nbytes, ops = scan_bwd_cost(side, enc, steps, 2)
        rows["K4"].append((1, ms, plain, nbytes, ops))
        report_scan("K4", side, enc, steps, with_x, ms, plain, nbytes, ops)
    k3, k3s, k4 = (summed(rows[k], BF16_TENSOR_FLOPS) for k in ("K3", "K3s", "K4"))
    warp_fwd, warp_bwd = time_warp(serve, warp_inputs)

    pred_l, train_l = serve["launches"], train["launches"]
    entries = [
        ("convlstm_gate_fwd (K1)", "triton", "vp_suite_tpu_torch/ops/cells.py",
         "vp_suite_tpu/ops/pallas_cells.py:37", pred_l["per_step"]["K1"], "K1", k1),
        ("convlstm_gate_bwd (K2)", "triton", "vp_suite_tpu_torch/ops/cells.py",
         "vp_suite_tpu/ops/pallas_cells.py:54", train_l["per_step"]["K2"], "K2", k2),
        ("convlstm_scan_fwd (K3)", "cuda", "vp_suite_tpu_torch/csrc/convlstm_scan.cu",
         "vp_suite_tpu/ops/pallas_convlstm.py:102", pred_l["fused_scan"]["K3"], "K3", k3),
        ("convlstm_scan_fwd save_gates (K3s)", "cuda", "vp_suite_tpu_torch/csrc/convlstm_scan.cu",
         "vp_suite_tpu/ops/pallas_convlstm.py:147", train_l["fused_scan"]["K3s"], "K3s", k3s),
        ("convlstm_scan_bwd (K4)", "cuda", "vp_suite_tpu_torch/csrc/convlstm_scan_bwd.cu",
         "vp_suite_tpu/ops/pallas_convlstm.py:166", train_l["fused_scan"]["K4"], "K4", k4),
        ("warp_sample_fwd (K5; also K7a, pallas_warp.py:116)", "cuda",
         "vp_suite_tpu_torch/csrc/warp_sample.cu", "vp_suite_tpu/ops/pallas_warp.py:277",
         pred_l["trajgru"]["warp_fwd"], "warp_fwd", warp_fwd),
        ("warp_sample_bwd (K6a, K6b; also K7b, K7c, pallas_warp.py:135, :157)", "cuda",
         "vp_suite_tpu_torch/csrc/warp_sample.cu", "vp_suite_tpu/ops/pallas_warp.py:294",
         train_l["trajgru"]["warp_bwd"], "warp_bwd", warp_bwd),
    ]
    return [dict(name=name, route=route, source=source, replaces=replaces, launches=launches,
                 max_abs_err=errs[kid], ms=t["ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"])
            for name, route, source, replaces, launches, kid, t in entries]


def cell_launches(model, side_of):
    r"""``{(side, channels): launches}`` of a per-step kernel that runs once
    per cell step of ``model`` in one predict (5 encoder and 10 forecaster
    steps per layer)."""
    launches = {}
    for rnns, steps in ((model.enc_rnns_list, CTX), (model.dec_rnns_list, PRED)):
        for rnn in rnns:
            shape = (side_of(rnn), rnn.enc_channels)
            launches[shape] = launches.get(shape, 0) + steps
    return launches


def grid_sample_library(iy, ix, img, g):
    r"""The one PyTorch call that computes the warp, and the one that computes
    its backward, in the image's dtype: ``F.grid_sample(align_corners=False,
    padding_mode="zeros")`` of the NCHW image at all b*P*L samples, as a grid
    ``[b, L*h, w, 2]``, and ``grid_sampler_2d_backward`` of it."""
    import torch
    import torch.nn.functional as F
    b, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([(2 * ix + 1) / w - 1, (2 * iy + 1) / h - 1], dim=-1) \
        .reshape(b, -1, w, 2).to(img.dtype)
    grad = g.reshape(b, -1, w, c).permute(0, 3, 1, 2).contiguous()
    fwd = lambda: F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=False)
    bwd = lambda: torch.ops.aten.grid_sampler_2d_backward(grad, x, grid, 0, 0, False,
                                                           [True, True])
    return fwd, bwd


def time_warp(serve, warp_inputs):
    r"""The warp's forward (per predict) and backward (per train step) at
    EF-TrajGRU's launch shapes, in bf16: device time from CUDA-graph replay
    (eager: back-to-back launches from Python), beside the plain versions,
    the bounds and ``F.grid_sample``."""
    from vp_suite_tpu_torch.ops.warp import (warp_sample_backward, warp_sample_backward_reference,
                                             warp_sample_forward, warp_sample_reference)
    launches = cell_launches(serve["suite"].models[list(PATHS).index("trajgru")].model,
                             lambda rnn: rnn.sh)
    check(sum(launches.values()) == serve["launches"]["trajgru"]["warp_fwd"],
          f"warp launch shapes {launches} do not add up to "
          f"{serve['launches']['trajgru']['warp_fwd']} launches")
    rows = {"fwd": [], "bwd": []}
    for (side, ch), steps in launches.items():
        iy, ix, img, g = warp_inputs[(side, ch)]
        lib_fwd, lib_bwd = grid_sample_library(iy, ix, img, g)
        for kid, fn, ref, lib, bwd in (
                ("fwd", lambda: warp_sample_forward(iy, ix, img),
                 lambda: warp_sample_reference(iy, ix, img), lib_fwd, False),
                ("bwd", lambda: warp_sample_backward(iy, ix, img, g),
                 lambda: warp_sample_backward_reference(iy, ix, img, g), lib_bwd, True)):
            ms = graph_ms(fn, iters=20)
            eager = cuda_ms(fn, warmup=3, iters=20)
            plain = cuda_ms(ref, warmup=1, iters=3)
            library = graph_ms(lib, iters=20)
            nbytes, ops = warp_cost(side, ch, 2, backward=bwd)
            bound, by = bound_ms(nbytes, ops, F32_FLOPS)
            print(f"[time] warp_{kid} {side}x{side}x{ch} b={B} L={TRAJ_L} bf16: "
                  f"{ms * 1e3:.1f} us/launch (eager {eager * 1e3:.1f} us, plain "
                  f"{plain * 1e3:.1f} us, F.grid_sample{'' if kid == 'fwd' else ' backward'} "
                  f"{library * 1e3:.1f} us, bound {bound * 1e3:.1f} us by {by}, "
                  f"{nbytes / 1e6:.1f} MB, {nbytes / ms / 1e9:.2f} TB/s), {steps} launches/"
                  f"{'predict' if kid == 'fwd' else 'train step'}")
            rows[kid].append((steps, ms, plain, nbytes, ops, library))
    return summed(rows["fwd"], F32_FLOPS), summed(rows["bwd"], F32_FLOPS)


def einsum_library(A, Bm, img):
    r"""``(ms, None)`` of ``torch.einsum("blpy,blpx,byxc->blpc", A, Bm, img)``,
    the one PyTorch call that computes K9's forward, or ``(None, reason)``
    where its intermediate does not fit the card."""
    import torch
    try:
        return cuda_ms(lambda: torch.einsum("blpy,blpx,byxc->blpc", A, Bm, img),
                       warmup=1, iters=3), None
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        return None, str(e).splitlines()[0]


def einsum_grad_comparison(A, Bm, img, g):
    r"""``(ms, None)`` of ``torch.autograd.grad`` through
    ``torch.einsum("blpy,blpx,byxc->blpc", ...)``, forward and backward, on
    K9's backward inputs, or ``(None, reason)`` where it does not fit the card.
    A comparison for K9's backward call, not one PyTorch call that computes
    it: the row's ``library_ms`` stays null."""
    import torch
    leaves = [a.detach().requires_grad_() for a in (A, Bm, img)]
    try:
        return cuda_ms(lambda: torch.autograd.grad(
            torch.einsum("blpy,blpx,byxc->blpc", *leaves), leaves, g), warmup=1, iters=3), None
    except torch.cuda.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        return None, str(e).splitlines()[0]


def time_factor_kernels(ret_inputs, contract_inputs, entry_launches, errs):
    r"""K8 and K9 per call at EF-TrajGRU's three layer shapes in bf16 (CUDA
    events over back-to-back calls; a forward call is one launch, a backward
    call K8's three or K9's two), beside their plain versions (one run each:
    K9's hold a 2 GB f32 intermediate per flow at 64x64), their bounds and:
    for K8, the unfused path TrajGRU runs, ``warp_flow_ret`` itself (the
    index math, the warp kernels and cuBLAS GEMMs), forward and backward
    through autograd on the same image, flows, weights and bias, eager and
    replayed from a CUDA graph, since no one PyTorch call computes the fused
    function; for K9's forward,
    ``torch.einsum``, and beside K9's backward call, as a comparison,
    ``torch.autograd.grad`` through it. Returns the kernels' JSON entries."""
    import torch
    from vp_suite_tpu_torch.ops.grid_sample import warp_flow_ret
    from vp_suite_tpu_torch.ops.warp import (warp_contract_backward,
                                             warp_contract_backward_reference,
                                             warp_contract_forward, warp_contract_reference,
                                             warp_ret_backward, warp_ret_backward_reference,
                                             warp_ret_forward, warp_ret_reference)
    rows = {k: [] for k in ("warp_ret_fwd", "warp_ret_bwd", "warp_contract_fwd",
                            "warp_contract_bwd")}
    #: warp_flow_ret's time summed over the shapes: (eager, on the card alone)
    unfused = {"warp_ret_fwd": [0.0, 0.0], "warp_ret_bwd": [0.0, 0.0]}
    for (side, ch), (iy, ix, img, w, bias, g, flows) in ret_inputs.items():
        def flow_fwd():
            return warp_flow_ret(img, flows, w.view(-1, 3 * ch), bias)

        def flow_fwd_bwd():
            leaves = [a.detach().requires_grad_() for a in (img, flows, w, bias)]
            out = warp_flow_ret(leaves[0], leaves[1], leaves[2].view(-1, 3 * ch), leaves[3])
            return torch.autograd.grad(out, leaves, g.view(out.shape))

        # warp_flow_ret eager (the host's dispatch of its some 15 launches
        # included) and replayed from a CUDA graph (the card alone); its
        # backward is forward and backward less the forward
        fwd = cuda_ms(flow_fwd, warmup=2, iters=10), graph_ms(flow_fwd, iters=20)
        both = cuda_ms(flow_fwd_bwd, warmup=2, iters=10), graph_ms(flow_fwd_bwd, iters=20)
        flow = {"warp_ret_fwd": fwd, "warp_ret_bwd": tuple(x - y for x, y in zip(both, fwd))}
        for kid, fn, ref in (
                ("warp_ret_fwd", lambda: warp_ret_forward(iy, ix, img, w, bias),
                 lambda: warp_ret_reference(iy, ix, img, w, bias)),
                ("warp_ret_bwd", lambda: warp_ret_backward(iy, ix, img, w, bias, g),
                 lambda: warp_ret_backward_reference(iy, ix, img, w, bias, g))):
            ms = cuda_ms(fn, warmup=2, iters=10)
            plain = cuda_ms(ref, warmup=0, iters=1)
            nbytes, ops = warp_ret_cost(side, ch, 2, backward=kid.endswith("bwd"))
            bound, by = bound_ms(nbytes, ops, BF16_TENSOR_FLOPS)
            eager, card = flow[kid]
            print(f"[time] {kid} (K8) {side}x{side}x{ch} b={B} L={TRAJ_L} O={3 * ch} bf16: "
                  f"{ms:.3f} ms/call (plain {plain:.3f} ms, warp_flow_ret's "
                  f"{'backward' if kid.endswith('bwd') else 'forward'} {card:.3f} ms on the "
                  f"card alone, {eager:.3f} ms eager, bound {bound:.3f} ms by {by}, "
                  f"{bound / ms:.1%} of it; {ops / ms / 1e9:.1f} TFLOP/s)")
            rows[kid].append((1, ms, plain, nbytes, ops))
            unfused[kid][0] += eager
            unfused[kid][1] += card
    for (side, ch), (A, Bm, img, g) in contract_inputs.items():
        library, why = einsum_library(A, Bm, img)
        grad_ms, grad_why = einsum_grad_comparison(A, Bm, img, g)
        for kid, fn, ref in (
                ("warp_contract_fwd", lambda: warp_contract_forward(A, Bm, img),
                 lambda: warp_contract_reference(A, Bm, img)),
                ("warp_contract_bwd", lambda: warp_contract_backward(A, Bm, img, g),
                 lambda: warp_contract_backward_reference(A, Bm, img, g))):
            ms = cuda_ms(fn, warmup=1, iters=5)
            plain = cuda_ms(ref, warmup=0, iters=1)
            nbytes, ops = contract_cost(side, ch, 2, backward=kid.endswith("bwd"))
            bound, by = bound_ms(nbytes, ops, BF16_TENSOR_FLOPS)
            lib = library if kid.endswith("fwd") else None
            if kid.endswith("bwd"):
                yard = (f", for comparison (not one call) autograd.grad through torch.einsum "
                        f"{grad_ms:.3f} ms" if grad_ms is not None
                        else f", autograd.grad through torch.einsum: {grad_why}")
            else:
                yard = f", torch.einsum {library:.3f} ms" if lib is not None \
                    else f", torch.einsum: {why}"
            print(f"[time] {kid} (K9) {side}x{side}x{ch} b={B} L={TRAJ_L} bf16: {ms:.3f} ms/call "
                  f"(plain {plain:.3f} ms{yard}, bound {bound:.3f} ms by {by}, "
                  f"{bound / ms:.1%} of it; {ops / ms / 1e9:.1f} TFLOP/s)")
            rows[kid].append((1, ms, plain, nbytes, ops) + (() if lib is None else (lib,)))
    t = {kid: summed(r, BF16_TENSOR_FLOPS) for kid, r in rows.items()}
    for kid in ("warp_contract_fwd", "warp_contract_bwd"):
        print(f"[time] {kid} (K9) over the three shapes: {t[kid]['ms']:.3f} ms, bound "
              f"{t[kid]['bound_ms']:.3f} ms ({t[kid]['bound_ms'] / t[kid]['ms']:.1%} of it)")
    print(f"[time] K8 over the three shapes: warp_ret forward {t['warp_ret_fwd']['ms']:.3f} ms "
          f"against warp_flow_ret's {unfused['warp_ret_fwd'][1]:.3f} ms on the card alone "
          f"({unfused['warp_ret_fwd'][0]:.3f} ms eager), backward {t['warp_ret_bwd']['ms']:.3f} "
          f"ms against {unfused['warp_ret_bwd'][1]:.3f} ms ({unfused['warp_ret_bwd'][0]:.3f} ms)")
    entries = [("warp_ret_fwd (K8a)", "vp_suite_tpu_torch/csrc/warp_ret.cu",
                "vp_suite_tpu/ops/pallas_warp.py:743", "warp_ret_fwd"),
               ("warp_ret_bwd (K8b, K8c; pallas_warp.py:771, :796)",
                "vp_suite_tpu_torch/csrc/warp_ret.cu", "vp_suite_tpu/ops/pallas_warp.py:771",
                "warp_ret_bwd"),
               ("warp_contract_fwd (K9a)", "vp_suite_tpu_torch/csrc/warp_contract.cu",
                "vp_suite_tpu/ops/pallas_warp.py:534", "warp_contract_fwd"),
               ("warp_contract_bwd (K9b, K9c; pallas_warp.py:581, :607)",
                "vp_suite_tpu_torch/csrc/warp_contract.cu", "vp_suite_tpu/ops/pallas_warp.py:581",
                "warp_contract_bwd")]
    return [dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=entry_launches[kid], max_abs_err=errs[kid], ms=t[kid]["ms"],
                 plain_ms=t[kid]["plain_ms"], bound_ms=t[kid]["bound_ms"],
                 bound_by=t[kid]["bound_by"], library_ms=t[kid]["library_ms"])
            for name, source, replaces, kid in entries]


def report_scan(kid, side, enc, steps, with_x, ms, plain, nbytes, ops):
    bound, by = bound_ms(nbytes, ops, BF16_TENSOR_FLOPS)
    print(f"[time] {kid} {side}x{side}x{enc} T={steps} {'with i2h' if with_x else 'decode'} "
          f"bf16: {ms:.3f} ms/launch (plain {plain:.3f} ms, bound {bound:.3f} ms by {by}; "
          f"{ops / ms / 1e9:.1f} TFLOP/s)")


def time_paths(serve, train):
    r"""``predict`` and the train step, each under the profiler once more;
    returns the median ``predict`` latency of each path in ms."""
    import torch
    suite, frames = serve["suite"], serve["frames"]
    predict_ms = {}
    for i, name in enumerate(PATHS):
        suite.predict(frames, pred_frames=PRED, model_idx=i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            suite.predict(frames, pred_frames=PRED, model_idx=i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        lat = predict_ms[name] = sorted(times)[len(times) // 2] * 1e3
        peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
        print(f"[time] predict {name} bf16 b={B} {CTX}->{PRED} at 64x64: median {lat:.2f} ms "
              f"(runs {', '.join(f'{t * 1e3:.2f}' for t in times)}), "
              f"{B * PRED / lat * 1e3:.0f} frames/s, peak memory {peak:.2f} GiB above what "
              f"was allocated before")
        profile(f"predict {name}", lambda: suite.predict(frames, pred_frames=PRED, model_idx=i),
                pick=("warp_fwd_kernel",) if name == "trajgru" else ())
    for name, s in train["steps"].items():
        print(f"[time] train step {name} bf16 b={B} {CTX}->{PRED} at 64x64: median "
              f"{s['lat']:.2f} ms, {B * (CTX + PRED) / s['lat'] * 1e3:.0f} frames/s, "
              f"peak memory {s['peak']:.2f} GiB above what was live before")
        profile(f"train step {name}",
                lambda: float(s["step"](s["state"], train["batch"])[1]["total"]),
                pick=("warp_fwd_kernel", "warp_bwd_kernel") if name == "trajgru" else ())
    return predict_ms


def profile(name, fn, pick=()):
    r"""One call of ``fn`` under ``torch.profiler``: device busy share and the
    kernels that take most of the device time, and the device time of the
    kernels whose names hold each string of ``pick``; returns ``(device ms,
    host ms)``, the device time None where the profiler saw no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy:
        print(f"[profile] {name}: device time not measured (the profiler saw no CUDA kernels)")
        return None, wall
    print(f"[profile] {name}: {busy:.2f} ms of device time in {wall:.2f} ms under the profiler "
          f"(busy {busy / wall:.0%}), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    for key in pick:
        hits = [e for e in kernels if key in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        print(f"[profile] {name}: {key} {ms:.3f} ms of the {busy:.2f} ms of device time "
              f"({ms / busy:.1%}), {sum(e.count for e in hits)} launches")
    return busy, wall


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.path.insert(0, str(ROOT))
        parallel_worker(*sys.argv[2:4])
    else:
        main()
