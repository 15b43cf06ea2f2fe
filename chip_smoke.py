#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (caffe_escoin_tpu_torch) on one GPU.

Drives the port's inference paths the way ``bench.py``'s ``run_e2e``
composes them (without buckets), first on the hand-written kernels' routes
(``use_xla_sparse=False``), unpacked:

* ResNet-50 at batch 32, 224x224, conv and fc weights pruned to 90% in
  128x128 blocks (the 3-channel stem stays dense), BatchNorm/Scale/ReLU/
  residual fused into the convs;
* VGG-16 at batch 16, 224x224, full width, the same pruning (each pruned
  weight scaled back to its norm, so that the signal survives thirteen
  pruned convs and three pruned fcs), fc6/fc7 ReLU fused, Dropout kept as
  the inference identity;
* GoogLeNet at batch 32, 224x224, full width and depth (``bench.py --model
  googlenet``), the same pruning where a conv has 32 or more input
  channels, each pruned weight scaled back to its norm: LRN, Concat and
  nine inception blocks;
* AlexNet at batch 32, 227x227 (``bench.py --model alexnet``), pruned the
  same way, grouped conv2/conv4/conv5 on block-diagonal weights, LRN;

all weight-aligned to BSC and run in SCONV_PAR mode in bf16 on the card;
then ResNet-50 as a bare ``python bench.py`` runs it: the XBSP arms,
measured autotune and whole-graph calibration, and GoogLeNet and AlexNet
the same way (phase 4b); then ResNet-50 as ``bench.py --granularity
unstructured`` prunes it, element-wise, run through the ELL gather SpMM
(phase 4c); then ResNet-50 and VGG-16 with the W-pair packed layout that a
bare ``bench.py`` applies (``--pack``), against the unpacked rows (phase
4d); then GoogLeNet in the three forms bench.py gives it: fused, with its
stem folded by space-to-depth, and folded and packed (phase 4e); then the
reference's own entry points, the command line and the parity tool, with
their model I/O, on ResNet-50 b32 (phase 6); then the training path, whose
trained, pruned AlexNet goes back onto the kernels (phase 7); then the data
slice: ResNet-50 fed by a Data layer over an LMDB, and AlexNet trained from
three sources (phase 8); then the parallel paths at world size 1 over
NCCL, the channel permutation and the image tools (phase 9); then the
example scripts on real digits: LeNet and AlexNet trained, pruned and
scored on the sparse paths, the siamese pair and the net surgery (phase
10); then the port's ``bench.py``, ``caffe_escoin_tpu_torch/bench.py``,
in each of its modes as a user runs it (phase 11), and its rows rendered
as the port's tables by ``tools/report.py`` (phase 12); then the probes of
``caffe_escoin_tpu_torch/experiments/`` (phase 13). Between them,
the three kernels multiplying in f32 (``mxu_dtype="float32"``, three TF32
products per multiply) at phase 3's shapes (phase 3f) and VGG-16 b16 and
ResNet-50 b32 run in f32 on them (phase 4f).

Phases, one line each (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: the three ported CUDA kernels, each with a bf16 and an f32
     entry, and the LRN and max-pool kernels (bf16 and f32 maps),
     from the sources in this checkout, and nvcc's register and spill
     report per kernel template, Rows policy and operand type (the direct
     convs' instances apart from the SpMM's; ``f32`` names the f32-operand
     families).
  3. parity: each kernel against its plain PyTorch version at main-path
     shapes, bf16, max|err| <= 1e-2 * max|plain| + 1e-2, after the launch
     plan (tile rows, ring stages, shared bytes) of each direct conv at
     that shape: sconv_fused at ResNet-50 shapes and at VGG-16 conv3_1,
     conv4_2 and conv5_2; bsc_spmm at ResNet-50 fc1000, VGG-16 fc6, fc7
     and fc8 (128x128 blocks) and conv1_2's lowered im2col GEMM (64x64
     blocks); sconv_gc at VGG-16 conv2_1, conv2_2 and conv3_2, and
     sconv_fused at those three too; then at the packed layout's shapes
     (``PACKED_SHAPES``), each weight repacked (``wpack.repack_weight``)
     from a logical weight pruned as the nets' are: sconv_fused at packed
     ResNet-50 b32's res2 3x3 [56, 28, 128] -> 128, its 1x1s 128 -> 512
     with the residual and 512 -> 128, res3a_branch1 512 -> 512 after its
     stride-(2, 1) subsampling, and sconv_gc (and sconv_fused) at packed
     VGG-16 b16's conv2_1 [112, 56, 128] -> 256; then at GoogLeNet b32's
     and AlexNet b32's shapes (``ZOO_SHAPES``: 5x5 kernels, K-blocks 32,
     48, 96 and 112 deep, block widths 16, 24 and 96, part-filled last
     columns at couts 208, 224, 288 and 320, each with a live block, Cin
     528, group=2) and bsc_spmm at AlexNet's fc6 (32 x 9216 -> 4096).
  3l. the LRN kernel (csrc/lrn.cu, a kernel of an op the JAX package
     leaves to XLA) at GoogLeNet b32's norm1 and norm2 in bf16: within one
     bf16 ulp of its plain version, one launch a call; timed eager and as
     a CUDA graph beside its plain version, ``F.local_response_norm`` on
     the map's NCHW view (the library's, timed here only; the port never
     calls it) and its bound, one bf16 read and one write at 3.35 TB/s.
  3m. the max-pool kernel (csrc/maxpool.cu, a kernel of an op the JAX
     package leaves to XLA) at b32's pool shapes in bf16 (``MAXPOOL_SHAPES``:
     GoogLeNet's and ResNet-50's pool1, GoogLeNet's pool2 and its
     inception_3a and 4e pools, VGG-16's pool1): its plain version's bits,
     one launch a call; timed eager and as a CUDA graph beside its plain
     version, ``F.max_pool2d`` on the map's NCHW view with Caffe's padding
     and ceil mode (the library's, timed here only) and its bound, one bf16
     read of the map and one write of the output at 3.35 TB/s.
  3e. the dense conv's epilogue kernel (csrc/conv_epilogue.cu, a kernel of
     an op the JAX package leaves to XLA) over cuDNN's bias-free output at
     b32's dense-conv maps in bf16 (``EPILOGUE_SHAPES``: VGG-16's conv1_2,
     ResNet-50's and GoogLeNet's conv1), bias and ReLU: its plain version's
     bits and the library's, one launch a call; timed eager and as a CUDA
     graph in place (as ``conv2d_dense`` runs it) beside its plain version,
     the broadcast ``add_`` of the bias over the channels_last NCHW output
     plus ``torch.relu`` (the library's: what ``F.conv2d`` with a bias ran,
     timed here only) and its bound, one bf16 read and one write of the map
     at 3.35 TB/s.
  3s. the stem conv kernel (csrc/stem_conv.cu, a kernel of an op the JAX
     package leaves to XLA) at the zoo's stems in bf16 (``STEM_SHAPES``:
     AlexNet's conv1 11x11/s4, the 7x7/s2/p3 conv1 of ResNet-50 and
     GoogLeNet, VGG-16's conv1_1 3x3/s1/p1, at b32 and b1), bias and ReLU:
     within the parity rule of its plain version (``F.conv2d`` with the
     bias in bf16, then ReLU), one launch a call; timed eager and as a CUDA
     graph beside its plain version, the former path (cuDNN's fprop
     without the bias, then the epilogue kernel: what ``conv2d_dense`` ran
     at these shapes before the stem kernel, timed here only as the
     yardstick) and its bound, max(bf16 image, weight and output bytes at
     3.35 TB/s, 2*M*Cout*kh*kw*Cin FLOPs at 989 TFLOP/s).
  3b. the XBSP arms (torch ops, no kernel of this package): unroll,
     gathered and gathered_cols at three ResNet-50 shapes (on the padded
     3x3 one also in the ``CESCOIN_XBSP_NOPAD`` pad-free form) and spmm at
     fc1000, in bf16, each against the f32 conv (``conv2d_dense``) or
     matmul (``linear``) on the f32 dense pruned weight, TF32 off, within
     the same limit; each timed eager and as a CUDA graph beside the dense
     bf16 cuDNN conv (or ``torch.addmm``) and its bound. Also the ELL gather
     SpMM (kernels/spmm.ell_spmm, torch ops) at res2's 3x3 (the ELL of
     W^T, 64 x 576 pruned element-wise to 90%, against the im2col's
     transpose, M = 32*56*56) in bf16 against the f32 product, timed
     beside ``torch.sparse.mm`` on a CSR of the same weight (cuSPARSE, the
     library the reference's csrmm2 path calls; never on the port's path)
     and its bound.
  3f. f32 multiplies: each kernel with ``mxu_dtype="float32"`` on f32
     weights and activations at phase 3's ResNet-50 and VGG-16 shapes
     (sconv_fused at the six, bsc_spmm at fc1000, fc6-8 and conv1_2's
     lowered GEMM, sconv_gc at the three gc layers), from generators of
     their own: max abs err within 2e-5 * max|ref| of its plain version
     computed in f64 on the card (one TF32 pass misses this by more than
     10x); each timed eager and as a CUDA graph beside its plain version in
     f32, one library call in f32 with TF32 off (``F.conv2d``
     channels_last, or ``torch.addmm``) and the f32 bound, max(f32 bytes /
     3.35 TB/s, FLOPs / 165 TFLOP/s: three passes at a third of the 495
     TF32 TFLOP/s). Every launch of the phase must multiply in f32; they
     are printed, not counted in the kernels line.
  4. nets, each on 4 distinct inputs with every launch counter set to 0
     just before and read just after: every kernel must have launched as
     many times as ``Net.launches`` declares (each route kernel once per
     route that names it, from the layers' routes, ``Net.routes``, the
     function the dispatch runs through; the LRN kernel once per LRN
     layer, GoogLeNet and AlexNet 2, ResNet-50 and VGG-16 0; the max-pool
     kernel once per max pool on an unpacked input, GoogLeNet 13,
     ResNet-50 1, VGG-16 5, AlexNet 3; the epilogue kernel once per dense
     conv with a bias, a ReLU or a residual; so too in phases 4b-4f and
     7c); the
     last classifier's logits within 5e-2
     relative L2 of the same pruned, fused net run dense in f32 (cuDNN,
     TF32 off). Also the routing's host time per layer (``Net.routes``,
     host clock).
  4b. ResNet-50 b32 autotuned, configured as bench.py's ``pol_sparse``:
     the XBSP branch (``use_xla_sparse``) with ``autotune`` on (the fused
     kernel competes where it runs the shape), on the same
     pruned, fused weights and the same 4 inputs as the ResNet-50 row, the
     cache in a fresh file under ``build/``. ``calibrate_graph`` with
     polish 8 under ``net_scope("resnet50")``, three times, each from an
     emptied cache (``autotune.clear()``, the file removed). Its
     ``time_fn`` is ``device_time`` of the whole forward, which captures
     the forward anew on each call (the trials change the routes) and
     times CUDA-graph replays cycling the 4 inputs; ``autotune.measure``
     times every candidate the same way. The first forward of each run
     measures every key; an arm or a forward that raises fails the run.
     Each run's ``calib`` line, every key's isolated arm times (each key
     must hold every arm ``ops.conv.conv_arms`` names, ``fused`` wherever
     ``fused_gate`` admits the key), each key's arm
     in the three runs and whether they agree. Then, on the last run's
     picks: the routes served from the cache, launches (``sconv_fused``
     once per "fused" route), the logits against dense f32 (same limit),
     the forward eager, as a CUDA graph and through
     ``inference_fn(cuda_graph=True)``, beside the kernel-route row's (the
     two graph times read kernel, autotuned, autotuned, kernel, each the
     mean of its two readings); the run fails if the autotuned CUDA graph
     takes more than ``AUTOTUNED_GRAPH_LIMIT`` times the kernel route's,
     and its message names the routes that are not ``fused``. Then the
     per-layer split by arm. No arm is measured during a CUDA-graph
     capture: autotune raises if it would. Then GoogLeNet b32 and AlexNet
     b32 (``CALIB_ONCE``): one calibration each from an emptied cache, its
     keys' arm times, launches, logits, both graph times and their ratio
     (printed, not held to a limit), and the per-layer split by arm.
  4c. ResNet-50 b32 unstructured: the kernel-route row's random weights
     (seed 0), its conv weights (the stem stays dense) pruned element-wise
     to 90% with ``prune_conv_weight(w, 0.9, None)`` and fc1000 with
     ``prune_magnitude``, fused, aligned under LOWERED_SPARSE with
     ``sparse_format=ELL`` (128x128 blocks for the BSC it also builds), in
     bf16. Routes (``Net.routes``): conv1 dense, the other 52 convs "ell",
     fc1000 dense (every 128x128 block of it is live). Every launch counter
     must read 0 over the 4 forwards: this path runs no hand kernel. The
     logits within 5e-2 relative L2 of the same pruned net run dense in
     f32; the forward eager, each layer alone as a CUDA graph, and each ELL
     layer's width and nnz.
  4d. packed: ``pack_narrow_chains`` on each fused sparse net, as bench.py
     packs its sparse arm, weight-aligned again (the packed weights) on
     the kernel routes; the packed blobs, routes and launches (which must
     be what ``Net.routes`` names and ``PACKED_LAUNCHES``), the logits
     within 5e-2 relative L2 of the unpacked dense f32 net (packing is
     exact), the forward eager and as a CUDA graph beside the unpacked
     kernel-route row in this call, and the layers packing changed, each
     alone as a CUDA graph, packed beside unpacked. For ResNet-50 b32 also
     the autotuned row packed: one ``calibrate_graph`` (polish 8) from an
     emptied cache under ``net_scope("resnet50_packed")``, every arm
     measured on every key, launches, logits, and its CUDA graph beside
     phase 4b's. The phase prints the packed / unpacked graph-time ratios;
     it fails on parity, launches or logits, never on speed. Nothing of
     AlexNet packs (the phase fails if that changes); GoogLeNet's packed
     form is phase 4e's.
  4e. GoogLeNet b32's stem transforms, on the kernel routes: the fused net,
     ``fold_stem_s2d`` of it (conv1 7x7/2 becomes a 4x4/1 conv over the
     [32, 115, 115, 12] space-to-depth grid) and ``pack_narrow_chains`` of
     that; each form's stem, packed blobs, routes and launches (as
     ``Net.routes`` names them), logits against the unfolded dense f32 net,
     and the stem layers, each alone as a CUDA graph, side by side with the
     s2d transform alone; the three CUDA-graph times in the order A B C C
     B A, each against the fused form's. Never fails on speed.
  4f. f32 nets: VGG-16 b16 and ResNet-50 b32 on their phase-4 rows'
     pruned, fused weights and inputs with ``compute_dtype=None,
     mxu_dtype="float32"``, on the kernel routes (``use_xla_sparse=False``;
     the reference's size gates read 4-byte items, so the routes differ
     from the bf16 rows': printed), then ResNet-50 autotuned with the same
     policy (one ``calibrate_graph`` from an emptied cache under
     ``net_scope("resnet50_f32")``; the XBSP arms and dense run f32 with
     TF32 off). Each: launches as ``Net.routes`` names them, every one
     multiplying in f32 (VGG-16 launches all three kernels); the last
     classifier's logits within 1e-4 relative L2 of the same net run dense
     in f32 with TF32 off; the f32 forward eager, as a CUDA graph and
     through ``inference_fn(cuda_graph=True)`` (which must give the eager
     forward's outputs) beside dense f32 and the bf16 kernel-route row;
     each layer alone as a CUDA graph, by route; the autotuned / f32
     kernel-route graph ratio (reported, not a limit).
  5. times (CUDA events, after warm-up, cycling the 4 inputs): each net
     sparse, dense-bf16 and dense-f32, eager, and the sparse and dense-bf16
     forwards replayed as CUDA graphs (their device time, without the
     host's dispatch); then each layer's device time in one sparse forward (the
     layer alone as a CUDA graph on its inputs), by route, and a layer
     that has none (LRN, Concat, Pooling, ...) by its type. Each kernel
     beside its plain version, one PyTorch library call computing the same
     function (``F.conv2d`` on the dense bf16 weight, channels_last, with
     bias and the weight's groups, for a conv; ``torch.addmm`` with the dense weight for an SpMM;
     the port never calls either), and sconv_gc beside sconv_fused on the
     same layer, each arm timed eager (20 calls between CUDA events, host
     dispatch included) and as a CUDA graph of 20 calls (device time; every
     graph time in this script is the median of 5 replays).
     Each line also gives the case's bound: the larger of its bytes over
     the card's memory rate and its FLOPs over the bf16 tensor-core rate
     (``BOUND_RATES``). The bytes count, once each, the columns of x (or
     of an SpMM's A) that some live weight block reads, the live weight
     blocks, the output and the residual; the FLOPs count the live
     blocks. Also the host time of one entry call of each kernel.
  6. the command line (``tools/cli.py``, ``tools/parity.py``, called in
     process) at ResNet-50 b32, 224x224, full depth and width, 1000
     classes, f32, unfused, 90% in 128x128 blocks: the JAX CLI's
     configuration (XBSP arms, no autotune). ``device_query``; ``parity``
     (LOWERED_SPARSE, SCONV and SCONV_PAR against LOWERED_GEMM, two
     batches, exit 0 under ``--tol 1e-3``); the model I/O round trip
     (``export_prototxt`` and ``export_caffemodel`` of the zoo net's random
     weights under ``build/``, then ``load_net`` + ``load_caffemodel`` +
     ``assign_to_params`` + ``batchnorm_state`` into a net initialised from
     another seed, pruned and aligned as the CLI does: its fc1000 logits on
     4 inputs within 1e-6 x max|logit| of the zoo net's); ``test`` on those
     files at --conv_mode 3 and 1 (forward ms per iteration, CUDA-graph
     replays after the capturing first one); ``time`` with the backward
     column (its totals, the five slowest layers; backward 0 exactly on the
     convs aligned with a BSC). Every launch counter must read 0 over it.
  7. training (f32, TF32 off; ``engine/solver.Solver``, the JAX package's
     documented AlexNet run cut to 16 steps). 7a: AlexNet b32, 227x227,
     1000 classes, full width and depth, xavier fillers, SGD at 0.01 with
     momentum 0.9 and L2 weight decay 5e-4, on ``synthetic_source``
     through ``PrefetchLoader`` (pinned host copies), under
     ``PruningSchedule(0.9, start 0, end 12, freq 4, block, 128x128)`` on
     the convs with cin >= 16 and the fc weights (conv1 dense, as
     examples/train_eval_sparse.py selects): per step the loss, the time
     between CUDA events around ``Solver.step``, whether the masks were
     recomputed and that host time; images/s over the steps after the
     first that recomputed none (the batch is taken from the loader before
     the events; its host wait is printed beside), with and without that
     wait; the peak device memory above what the earlier phases hold; then
     2 more steady steps under ``torch.profiler``: the host time per step,
     the device's busy time and share, and the kernels that fill it. It
     fails on a loss that is not finite, a masked weight that is not
     exactly 0, or a pruned layer whose share of zero 128x128 blocks
     (per-offset planes for a conv) is off 0.9 by more than one block's
     share; then ``test_all``
     on the test-phase net (2 batches). 7b: one step from the same params
     on the card and on the CPU, AlexNet b8 with both Dropout ratios 0 and
     cifar10_bn at b100 (BatchNorm in training mode), and on the CPU in f64
     as the reference: the loss within 1e-4 relative, each param's update
     within 1e-3 relative L2 of the CPU's, or within twice the CPU f32
     update's own distance from the f64 one where that is larger (conv1's
     weight gradient is about 1e-3 off in f32 on either device); a conv
     bias that feeds a BatchNorm, whose update is rounding noise, within
     1e-6 absolute; the BatchNorm state within 1e-4. 7c: the trained weights
     on the test-phase net, fused, aligned in SCONV_PAR, bf16,
     ``use_xla_sparse=False``, on 4 inputs: launches equal to what
     ``Net.routes`` names, which must be 4 ``sconv_fused`` + 3
     ``bsc_spmm``, and 2 LRN launches; fc8's logits within 5e-2 relative L2 of the same
     weights dense in f32; its CUDA-graph time beside phase 5's AlexNet
     row. 7d: ``cli train --model alexnet --batch 32 --num-classes 1000
     --iterations 4`` (snapshot under build/), then ``cli test --weights``
     on that snapshot at ``--conv_mode 3 --sparsity 0.9``: its forward
     times, and every route kernel's launch counter at 0 (training runs
     dense, the command line's test the XBSP arms; the LRN kernel runs
     there, uncounted).
  8. the data slice, every file in a temporary directory. 8a: 256 random
     uint8 images 3x256x256 from seed 0 written as an LMDB
     (``write_lmdb`` + ``datum_encode``, 50 MB) and as a ``.cerec``, and
     their mean by ``cli compute_image_mean``; where PIL imports, 64 of
     them as PNGs through ``cli convert_imageset --backend lmdb``, whose
     pixels must read back equal (else the line says why it skipped).
     8b: ResNet-50 b32 built by ``net_from_prototxt(...,
     synthesize_data=False)`` from prototxt text whose first layer is a
     TEST-phase Data layer over the LMDB (``crop_size: 224``,
     ``mean_file``) and then the ZOO's ResNet-50; the net's device is None
     (the card); pruned, fused and aligned as phase 4's kernel-route row:
     launches over 4 forwards equal to ``Net.routes`` (51 ``sconv_fused``,
     1 ``bsc_spmm`` each), fc1000 within 5e-2 relative L2 of the dense f32
     net on the same transformed batches; the eager forward with the pop
     and the loader's waits. 8c: AlexNet b32 as phase 7a (xavier, SGD 0.01,
     momentum 0.9, weight decay 5e-4, f32, no pruning schedule) for 8
     steps from each of three sources: the synthetic ``PrefetchLoader``;
     ``NativeCerecLoader`` (2 C++ workers, shuffled) over the ``.cerec``
     with the TRAIN transformer (crop 227, mirror, the mean, scale 1/128)
     on a ``PrefetchLoader`` thread; the Data layer over the LMDB with the
     same transform. Per source the ms per step between CUDA events, the
     wall per step with the batch, images/s and the loader's waits; every
     loss finite. 8d: the native host library must build (``build/
     native/``); a ResNet-50 stride-1 layer (res3 3x3, b32, 28x28,
     128->128, 90% in 32x32 blocks) through ``native_cpu`` on CPU tensors
     (``ops.conv.conv2d``, the C++ conv counted) against the plain f32
     conv, max abs err <= 1e-4 max|ref|; its host ms and the CPU's name.
     8e: Deconvolution, SPP, Im2col, RNN, LSTM, LSTMUnit, Embed,
     BatchReindex, Filter, Parameter, Python, a 3-D convolution and
     stochastic pooling (TEST) once on the card and once on the CPU on the
     same f32 inputs and params, within 1e-4 relative L2; stochastic
     pooling's TRAIN draw on a CUDA generator must pick window members.
     Every loader wait has a timeout, so a hang fails the run.
  9. parallel/ at world size 1 over NCCL, in a group made from an
     in-process store (destroyed at the end); every run's launches counted
     (set to 0 just before, read just after) against what its routes name.
     9a: ``halo.spatial_sconv2d(engine="pallas")`` at VGG-16 conv2_2 (b16
     112x112, 128->128, 90% in 128x128 blocks, bf16): 1 ``sconv_gc``
     launch, max|halo - sconv_gc.sconv(x, padding=(1, 1))| exactly 0 (the
     slab is the same bytes), both timed (``device_time``); the halo chain
     and tower over VGG-16 conv3_1-3_3 (b16 56x56) against the three convs
     in sequence, within the bf16 rule. 9b: ``tp.tp_conv_lowered`` at
     VGG-16 conv1_2 (b16 224x224, 64->64, 64x64 blocks): 1 ``bsc_spmm``
     launch, exactly the lowered route's output, both timed. 9c: one
     ``dp.make_dp_train_step`` step of AlexNet b32 (phase 7a's config,
     deterministic cuDNN) against one ``Solver`` step from the same params,
     every update within 1e-6 relative L2; ``make_dp_eval_step`` on
     ResNet-50 b32 on the kernel routes (launches equal to ``Net.routes``,
     prob within 5e-2 of dense f32); ``scaling.measure`` (kernel routes),
     ``measure_halo`` and ``measure_tp`` at world 1 with the card's name and
     power limit; ``dryrun_multichip(1)``. 9d: ResNet-50 pruned element-wise
     to 90% (phase 4c's weights), fused: ``permute.deploy_unstructured`` at
     min_density 0 must leave the f32 ELL route's fc1000 within 1e-3
     relative L2, and its live-block counts before and after are printed
     (random weights: almost no reduction expected, none claimed); at
     min_density 0.05, aligned to 128x128 BSC on the kernel routes:
     launches equal to ``Net.routes``, fc1000 within 5e-2 of dense f32 on
     the deployed weights. 9e: ``vision.Classifier.predict`` on AlexNet
     (fused, without its Softmax, kernel routes): 4 images 256x256 become
     40 crops, the averaged fc8 within 5e-2 relative L2 of the dense f32
     net's; ``Detector.detect_windows`` on 8 windows likewise. The phase's
     wall time beside its 60 s budget.
  10. the example scripts (``caffe_escoin_tpu_torch/examples/``, called in
     process through their ``run``) on the 1,797 real digits, f32 with
     TF32 off; each step of every Solver timed between CUDA events around
     ``Solver._step`` beside the wall per step and the mask recomputes'
     host time. 10a: ``train_eval_sparse`` as docs/EXPERIMENTS.md's LeNet
     table (``EX_LENET``: 800 iterations, one-shot element-wise and 8x8
     block legs at 70/80/90% with 300 masked fine-tune steps each, the
     unstructured deployment at 90%), scored dense and on the XBSP arms
     (SCONV_PAR, bf16 products): dense accuracy >= 0.95, every row's
     achieved sparsity within 0.01 of its target and its sparse score
     within 2/256 of its fine-tuned one; the table printed. 10b: AlexNet
     as docs/EXPERIMENTS_alexnet.md:76-79 (227x227, b64, xavier, SGD 0.01,
     gradual 90% in 128x128 blocks; ``EX_ALEXNET``) with its steps cut to
     60 dense + 60 ramp + 20 frozen (``--examples-full``: 1200 + 800 +
     500, phase 10 alone after the build): every loss finite, each pruned
     weight's zero-block share 0.9 +- one block, the sparse score within
     2/256; then the same weights aligned with ``use_xla_sparse=False`` on
     the 256 test digits: launches equal to what ``Net.routes`` names (4
     ``sconv_fused`` and 3 ``bsc_spmm`` per batch, fc8's 4096x10 BSC with
     bn 16 among them), fc8 within 5e-2 relative L2 of the same weights
     dense f32, the accuracy within 2/256 of the XBSP score. 10c:
     ``siamese_digits`` at its defaults (400 iterations, b64): one
     parameter copy, negative pairs farther apart than positive ones.
     10d: ``net_surgery`` (CaffeNet, 100 classes): the 227x227 score map
     within 1e-5 of the classifier's probabilities, a 451x451 input gives
     a map larger than 1x1. Every other part launches no kernel (counted).
     The phase's wall time beside its 90 s budget.
  11. the port's bench (``caffe_escoin_tpu_torch/bench.py``): each run of
     ``BENCH_RUNS`` called in process as ``bench.main(argv)``, with its
     own autotune table (``BENCH_AUTOTUNE_CACHE``, emptied first) and the
     launch counts set to 0 before it; each run's last stdout line must
     parse as JSON with ``bench.py``'s keys for its mode (``BENCH_KEYS``)
     plus ``device``, which must name the card, and a positive value.
     Bare (ResNet-50 b32, e2e, buckets, calibrated with polish 8): it
     must launch ``sconv_fused``; its nets prepared again from seed 0
     (``bench.prepare_e2e``) must launch, over the 4 inputs, what
     ``Net.routes`` names from the calibrated table (which must need no
     new measurement), and give fc1000 within 5e-2 relative L2 of the
     same pruned weights dense in f32. Bare with ``--weights-as-args``:
     its line says ``"weights_as_args": true``; the bare run's nets,
     with the table as this run left it, forward the 4 inputs over
     grafted payloads (``split_payloads``) and closed over: the same
     launches, what ``Net.routes`` names, and fc1000 bit for bit (and,
     where the calibrated routes are the bare run's, the bare run's
     launches and fc1000 bits). ``--xbsp-arm fused
     --no-autotune`` b32: ``sconv_fused`` launches equal to 2 x 4
     forwards (``device_time``'s eager call and capture per input) of
     what ``Net.routes`` names. ``--per-layer`` b32, every eligible
     config: each row's err within 1e-2 * max|ref| + 1e-2 of the dense
     f32 conv on the same draws (``bench.per_layer_cases``). ``--fc``
     VGG-16 b16. ``--halo`` b16: ``sconv_gc`` launched, the halo path
     bit-equal to ``sconv_gc`` on the whole map, the one-entry chain
     bit-equal to its convs in sequence (``err_chain``), its rows appended to
     ``build/SCALING.jsonl`` and the JAX package's ``SCALING.jsonl``
     unchanged. ``--batch-curve``: a row per batch. ``--granularity
     unstructured`` b32: no launch (every 128x128 block stays live, every
     route is dense). Each run's stdout is in ``build/bench_<i>.log``;
     every run but ``--halo`` appends its rows and headline to
     ``build/BENCH_SWEEP.jsonl`` (``--jsonl``), ``--halo`` to
     ``build/SCALING.jsonl``, both emptied first. The phase's wall time
     beside its 300 s budget.
  12. the tables (``caffe_escoin_tpu_torch/tools/report.py``): phase 11's
     two records loaded (a row without the card's label is refused, and
     fails the phase) and rendered to ``build/BENCH_TABLES.md``; every
     section must be headed by the card's name and power limit, and every
     run of phase 11 must appear: each e2e, per-layer and fc headline as
     its table's row, the batch curve's rows and peak, and the halo run's
     single-conv rows (the reference's halo table renders those, not the
     headline; a group of e2e captures, as the bare run with and without
     ``--weights-as-args``, as its best row).
  13. the probes (``caffe_escoin_tpu_torch/experiments/``): each run of
     ``EXP_RUNS`` called in process as ``main(argv)`` (``stability``
     spawns its phases' processes), with an autotune table of its own
     (``EXP_AUTOTUNE_CACHE``, emptied first) and the launch counts set to
     0 before it; rows in ``build/experiments/*.jsonl``, each run's
     stdout in ``build/experiments_<i>.log``. ``opprofile`` ResNet-50 b32
     packed and GoogLeNet b16 (12 profiled forwards each, as CUDA-graph
     replays and layer by layer; the top kernels and their layers
     printed); ``pool``'s six shapes; ``k3`` at 56 and 7; ``s2d``'s three
     stems; ``wpack``; ``stability`` phases A and D (50 host-clocked
     replays each); ``rss_probe train`` 200 iterations. Fails on an error
     row, a row without the card's label, a pool candidate that is not
     ``torch.equal`` (or an s2d fold off by more than its tolerance), a
     k3 arm or a wpack check over 1e-2 * max|ref| + 1e-2, a k3 run
     without its ``fused_cuda`` rows and ``sconv_fused`` launches, and a
     ResNet-50 profile whose kernel table (of either form that shows
     kernels) lacks ``sconv_fused`` or whose layer-by-layer
     ``sconv_fused`` calls per forward differ from the launch counter's
     over the profiled forwards. The phase's wall time beside its 150 s
     budget.
Then one JSON line with the kernels: ``ms``, ``plain_ms`` and
``library_ms`` are eager times summed over the timed shapes, ``graph_ms``,
``graph_plain_ms`` and ``graph_library_ms`` the same as CUDA graphs;
``launches`` sums the nets' runs (phases 4, 4b, 4c, 4d, 4e, 7c, 8b, 9
and 10b's kernel routes, phase 11's bare, weights-as-args and
forced-fused forwards and halo run, and phase 13's probes; phase 6 and
the rest of phases 7, 8, 10 and 11 are not counted there). Each kernel is followed by its f32-multiply variant
(``<name>_f32``: the same source and TPU kernel, phase 3f's errors and
times with the f32 bound, phase 4f's launches). Last come the LRN kernel
(``lrn``, ``replaces`` null): phase 3l's errors, times and bound, and its
launches in phases 4, 4b-4f and 7c, one per LRN layer of each forward
(GoogLeNet's and AlexNet's two, none in ResNet-50 or VGG-16), checked
there against that count; the max-pool kernel (``maxpool``,
``replaces`` null): phase 3m's, and its launches there, one per max pool
on an unpacked input; and the dense conv's epilogue kernel
(``conv_epilogue``, ``replaces`` null): phase 3e's, and its launches there,
one per dense conv with a bias, a ReLU or a residual that the stem kernel
does not take; and the stem conv kernel (``stem_conv``, ``replaces``
null): phase 3s's, and its launches there, one per bf16 stem. As the last
line
{"ok": true, "device": {...}}.

Run from the repository root: ``python3 chip_smoke.py`` (or
``python3 chip_smoke.py --examples-full``: the build and phase 10 alone,
10b at full length). Needs one CUDA device and nvcc; exits 1 without them.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SPARSITY = 0.9
BLOCK = (128, 128)
SEED = 0
N_INPUTS = 4
TIMED_ITERS = 20
# a CUDA graph's time is the median of this many replays, each between its
# own events: one replay alone has read 2.6x its usual time once
GRAPH_REPLAYS = 5
PARITY_REL, PARITY_ABS = 1e-2, 1e-2
LOGITS_REL_L2 = 5e-2
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16
# tensor-core FLOP/s, at the full 700 W power limit
BOUND_RATES = {"bytes": 3.35e12, "operations": 989e12}
# the same for f32 multiplies: three TF32 passes per product, a third of the
# 495 TF32 TFLOP/s
BOUND_RATES_F32 = {"bytes": 3.35e12, "operations": 495e12 / 3}
KERNELS = {  # name -> the TPU kernel it replaces
    "sconv_fused": "caffe_escoin_tpu/kernels/sconv_fused.py:263",
    "bsc_spmm": "caffe_escoin_tpu/kernels/bsc_pallas.py:125",
    "sconv_gc": "caffe_escoin_tpu/kernels/sconv_pallas.py:157",
}
# the f32-multiply variant of each (mxu_dtype="float32"; phases 3f and 4f),
# listed beside it in the kernels line
KERNELS_F32 = {f"{k}_f32": k for k in KERNELS}
# the hand kernels of ops that the JAX package leaves to XLA: one launch per
# LRN layer, and per max pool on an unpacked input, of a forward on the
# card, whatever the routes
LRN_KERNEL = "lrn"
MAXPOOL_KERNEL = "maxpool"
EPILOGUE_KERNEL = "conv_epilogue"
STEM_KERNEL = "stem_conv"
# phase 3f: each kernel multiplying in f32 against its plain version in f64
# on the card, max abs err within this share of max|ref| (one TF32 pass
# misses it by more than 10x)
F32_PARITY_REL = 2e-5
# phase 4f: the nets in f32 on the kernel routes (and ResNet-50 autotuned)
# against the same pruned, fused net run dense in f32, TF32 off
F32_NETS = ("vgg16", "resnet50")
F32_LOGITS_REL_L2 = 1e-4
# logits: the last classifier's blob; input_scale: the std of the random
# inputs; keep_norm: see _prune
NETS = [
    dict(model="resnet50", batch=32, logits="fc1000", width=1000,
         input_scale=0.1, keep_norm=False),
    dict(model="vgg16", batch=16, logits="fc8", width=1000,
         input_scale=1.0, keep_norm=True),
    dict(model="googlenet", batch=32, logits="loss3/classifier", width=1000,
         input_scale=1.0, keep_norm=True),
    dict(model="alexnet", batch=32, logits="fc8", width=1000,
         input_scale=1.0, keep_norm=True),
]
ROUTE_REPS = 100
# phase 3l: the LRN kernel at GoogLeNet b32's norm1 and norm2 (Caffe's
# alpha 1e-4, beta 0.75, k 1, n 5), on activations of this scale
LRN_SHAPES = (("norm1 b32 56x56x64", (32, 56, 56, 64)),
              ("norm2 b32 56x56x192", (32, 56, 56, 192)))
LRN_PARAMS = dict(local_size=5, alpha=1e-4, beta=0.75, k=1.0)
LRN_SCALE = 30.0
# phase 3m: the max-pool kernel at the benchmark's b32 pool shapes, (label,
# map, kernel, stride, padding), ceil mode
MAXPOOL_SHAPES = (
    ("pool1 b32 112x112x64 3x3/s2 (GoogLeNet, ResNet-50)",
     (32, 112, 112, 64), 3, 2, 0),
    ("googlenet pool2 b32 56x56x192 3x3/s2", (32, 56, 56, 192), 3, 2, 0),
    ("googlenet inception_3a/pool b32 28x28x192 3x3/s1/p1",
     (32, 28, 28, 192), 3, 1, 1),
    ("googlenet inception_4e/pool b32 14x14x528 3x3/s1/p1",
     (32, 14, 14, 528), 3, 1, 1),
    ("vgg16 pool1 b32 224x224x64 2x2/s2", (32, 224, 224, 64), 2, 2, 0),
)
# phase 3e: the epilogue kernel at b32's dense-conv output maps, (label, map)
EPILOGUE_SHAPES = (
    ("vgg16 conv1_2 b32 224x224x64", (32, 224, 224, 64)),
    ("conv1 b32 112x112x64 (ResNet-50, GoogLeNet)", (32, 112, 112, 64)),
)
# phase 3s: (label, image NHWC, kernel, stride, pad, Cout) of the zoo's stems
STEM_SHAPES = (
    ("alexnet conv1 b32 227x227x3 11x11/s4 -> 96", (32, 227, 227, 3), 11, 4,
     0, 96),
    ("resnet50/googlenet conv1 b32 224x224x3 7x7/s2/p3 -> 64",
     (32, 224, 224, 3), 7, 2, 3, 64),
    ("vgg16 conv1_1 b32 224x224x3 3x3/s1/p1 -> 64", (32, 224, 224, 3), 3, 1,
     1, 64),
    ("alexnet conv1 b1", (1, 227, 227, 3), 11, 4, 0, 96),
    ("resnet50/googlenet conv1 b1", (1, 224, 224, 3), 7, 2, 3, 64),
)
# the autotuned row: bench.py's calibration (polish 8, net scope), and a
# cache file of this run's own (gitignored, deleted first)
CALIB_POLISH = 8
CALIB_REPS = 8
CALIB_RUNS = 3
AUTOTUNE_CACHE = "build/chip_smoke_autotune.json"
# the autotuned forward as a CUDA graph may take at most this many times the
# kernel route's: its router reads device time, and the fused kernel is
# among its candidates
AUTOTUNED_GRAPH_LIMIT = 1.15
# the packed layout (phase 4d): the kernels' packed shapes, (label, batch,
# h, packed w, logical cin, logical cout, k, r_in, r_out, logical W stride,
# relu, residual, kernels that take it, the first timed as "kernel")
PACKED_SHAPES = [
    ("packed res2 3x3 b32 56x28 128->128 +relu", 32, 56, 28, 64, 64, 3, 2,
     2, 1, True, False, ("sconv_fused",)),
    ("packed res2 expand 1x1 b32 56x28 128->512 +res+relu", 32, 56, 28, 64,
     256, 1, 2, 2, 1, True, True, ("sconv_fused",)),
    ("packed res2 reduce 1x1 b32 56x28 512->128 +relu", 32, 56, 28, 256, 64,
     1, 2, 2, 1, True, False, ("sconv_fused",)),
    ("packed res3a_branch1 1x1 stride (2,1), subsampled b32 28x28 512->512",
     32, 28, 28, 256, 512, 1, 2, 1, 2, False, False, ("sconv_fused",)),
    ("packed conv2_1 b16 112x56 128->256 3x3 +relu", 16, 112, 56, 64, 128,
     3, 2, 2, 1, True, False, ("sconv_gc", "sconv_fused")),
]
# the kernels' launches per packed forward (phase 4d; what Net.routes names
# on the kernel routes, held by tests/test_torch_routes.py)
PACKED_LAUNCHES = {
    "resnet50": {"sconv_fused": 52, "bsc_spmm": 1},
    "vgg16": {"sconv_fused": 7, "sconv_gc": 4, "bsc_spmm": 4},
}
# GoogLeNet b32's and AlexNet b32's shapes that no earlier net gave the
# kernels (phase 3): (label, batch, h, cin, cout, k, pad, group), each with
# ReLU, weights pruned as the nets' are, but a part-full last block column
# keeps its centre tap live (pruning ranks it low, as its zero padding
# counts in its norm, so the nets' own weights seldom reach it)
ZOO_SHAPES = [
    ("inception_3b/5x5 b32 28x28 32->96 5x5 +relu", 32, 28, 32, 96, 5, 2, 1),
    ("inception_4a/3x3 b32 14x14 96->208 3x3 +relu", 32, 14, 96, 208, 3, 1,
     1),
    ("inception_4b/3x3 b32 14x14 112->224 3x3 +relu", 32, 14, 112, 224, 3,
     1, 1),
    ("inception_4b/5x5_reduce b32 14x14 512->24 1x1 +relu", 32, 14, 512, 24,
     1, 0, 1),
    ("inception_4d/3x3 b32 14x14 144->288 3x3 +relu", 32, 14, 144, 288, 3,
     1, 1),
    ("inception_4e/3x3 b32 14x14 160->320 3x3 +relu", 32, 14, 160, 320, 3,
     1, 1),
    ("inception_4e/1x1 b32 14x14 528->256 1x1 +relu", 32, 14, 528, 256, 1,
     0, 1),
    ("inception_4a/5x5_reduce b32 14x14 480->16 1x1 +relu", 32, 14, 480, 16,
     1, 0, 1),
    ("inception_5b/5x5 b32 7x7 48->128 5x5 +relu", 32, 7, 48, 128, 5, 2, 1),
    ("alexnet conv2 b32 27x27 96->256 5x5 group 2 +relu", 32, 27, 96, 256, 5,
     2, 2),
    ("alexnet conv4 b32 13x13 384->384 3x3 group 2 +relu", 32, 13, 384, 384,
     3, 1, 2),
]
# the nets calibrated once each from an empty cache after ResNet-50's three
# runs (phase 4b); their autotuned / kernel-route graph ratio is reported,
# not held to a limit yet
CALIB_ONCE = ("googlenet", "alexnet")
# the command line's run (phase 6): the JAX CLI's configuration (f32,
# unfused, XBSP arms, no autotune) at full depth and width
CLI_MODEL, CLI_BATCH, CLI_CLASSES = "resnet50", 32, 1000
CLI_ITERS = 5
CLI_TIME_ITERS = 5
# phase 7: training, the JAX package's documented AlexNet run
# (docs/EXPERIMENTS_alexnet*.md, examples/train_eval_sparse.py: xavier
# fillers, SGD at 0.01 with momentum 0.9, weight decay 5e-4, gradual block
# pruning to 90% in 128x128 blocks) at batch 32, cut to 16 steps
TRAIN_BATCH, TRAIN_CLASSES, TRAIN_STEPS = 32, 1000, 16
TRAIN_SCHEDULE = dict(final_sparsity=SPARSITY, start_iter=0, end_iter=12,
                      freq=4, granularity="block", block_shape=BLOCK)
TRAIN_TEST_BATCHES = 2
# steady steps run under torch.profiler after the 16 (masks frozen): the
# device's busy share of a step and the kernels that fill it
PROFILE_STEPS = 2
# phase 7b: one step on the card against the same step on the CPU; (model,
# batch) with AlexNet's Dropout ratios set to 0 (the generators differ)
STEP_NETS = (("alexnet", 8), ("cifar10_bn", 100))
STEP_LOSS_REL, STEP_UPDATE_REL, STEP_BN_TOL = 1e-4, 1e-3, 1e-4
# phase 7c: what the trained, pruned AlexNet must launch per forward
TRAINED_LAUNCHES = {"sconv_fused": 4, "bsc_spmm": 3, "sconv_gc": 0,
                    LRN_KERNEL: 2, MAXPOOL_KERNEL: 3, EPILOGUE_KERNEL: 0,
                    STEM_KERNEL: 1}
CLI_TRAIN_ITERS = 4
# the GoogLeNet stem layers phase 4e prints side by side
STEM_LAYERS = ("conv1/7x7_s2", "pool1/3x3_s2", "pool1/norm1",
               "conv2/3x3_reduce", "conv2/3x3", "conv2/norm2", "pool2/3x3_s2")

# phase 8: the data slice. DATA_IMAGES random uint8 images from seed 0 in an
# LMDB and a .cerec; ResNet-50 b32 from a TEST-phase Data layer over the
# LMDB, whose routes must name DATA_RESNET_LAUNCHES; AlexNet b32 trained
# DATA_TRAIN_STEPS steps from each of three sources; the native host conv at
# one ResNet-50 layer (NATIVE_SHAPE: label, batch, h, cin, cout, k, pad,
# block); the rest of the layer catalog on the card against the CPU
DATA_IMAGES, DATA_HW, DATA_CLASSES, DATA_BATCH = 256, 256, 1000, 32
DATA_PNGS = 64
DATA_TIMED = 8
DATA_TRAIN_STEPS = 8
# 8c's transform scale: mean-subtracted pixels times 1/128 span about the
# synthetic source's range, where phase 7a's xavier + SGD 0.01 run is
# stable; at the raw pixel range its loss diverges within three steps
DATA_TRAIN_SCALE = 1.0 / 128
DATA_WAIT_TIMEOUT = 120.0
DATA_RESNET_LAUNCHES = {"sconv_fused": 51, "bsc_spmm": 1}
DATA_LAYER = """layer {{ name: "data" type: "Data" top: "data" top: "label"
  include {{ phase: TEST }}
  transform_param {{ crop_size: 224 mean_file: "{mean}" }}
  data_param {{ source: "{db}" batch_size: {batch} backend: LMDB }} }}"""
NATIVE_SHAPE = ("res3 3x3 b32 28x28 128->128", 32, 28, 128, 128, 3, 1,
                (32, 32))
NATIVE_REPS = 3
# (type, params, bottoms, tops): a shape is a normal f32 bottom; "cont" the
# [T, N] indicator, "idx" indices into 10 rows, "reindex" 5 batch indices,
# "sel" a selector over 6 items, "pos" a positive map; Python's params are
# the phase's own user layer
CATALOG_CASES = [
    ("Deconvolution", dict(num_output=8, kernel=4, stride=2, pad=1),
     [(2, 14, 14, 16)], 1),
    ("SPP", dict(pyramid_height=3), [(2, 13, 13, 8)], 1),
    ("Im2col", dict(kernel=3, stride=2, pad=1), [(2, 9, 9, 4)], 1),
    ("RNN", dict(num_output=16), [(6, 4, 8), "cont"], 1),
    ("LSTM", dict(num_output=16), [(6, 4, 8), "cont"], 1),
    ("LSTMUnit", {}, [(4, 16), (4, 64), (4,)], 2),
    ("Embed", dict(input_dim=10, num_output=12), ["idx"], 1),
    ("BatchReindex", {}, [(6, 3, 2), "reindex"], 1),
    ("Filter", {}, [(6, 3, 2), "sel"], 2),
    ("Parameter", dict(shape=(3, 4), filler={"type": "gaussian"}), [], 1),
    ("Python", {}, [(2, 5, 5, 3)], 1),
    ("Convolution", dict(num_output=6, kernel=3, pad=1), [(2, 4, 6, 6, 4)],
     1),
    ("Pooling", dict(kernel=3, stride=2, mode="stochastic"), ["pos"], 1),
]
CATALOG_REL_L2 = 1e-4
# phase 9: parallel/ at world size 1 over NCCL. The halo path at VGG-16
# conv2_2 (label, batch, h=w, cin, cout) and the halo chain and tower over
# conv3_1-3_3 (batch, h=w, (cin, cout) per conv); tp_conv_lowered at VGG-16
# conv1_2 in 64x64 blocks, the lowered row of PERF.md (label, batch, h=w,
# cin, cout, block); the DP step (AlexNet) and eval (ResNet-50) batch; the
# permutation's densification threshold; the Classifier's images and the
# Detector's windows
PAR_HALO = ("vgg16 conv2_2", 16, 112, 128, 128)
PAR_STACK = (16, 56, ((128, 256), (256, 256), (256, 256)))
PAR_TP = ("vgg16 conv1_2", 16, 224, 64, 64, (64, 64))
PAR_DP_BATCH = 32
PAR_MIN_DENSITY = 0.05
PAR_VISION_IMAGES, PAR_VISION_HW, PAR_WINDOWS = 4, 256, 8
DP_UPDATE_REL = 1e-6
PERMUTE_LOSSLESS_REL = 1e-3
PAR_BUDGET_S = 60
# phase 10: the examples (caffe_escoin_tpu_torch/examples/). 10a:
# docs/EXPERIMENTS.md's LeNet table (800 iterations; element-wise and 8x8
# block one-shot legs at 70/80/90%, 300 fine-tune steps each; the
# unstructured deployment at 90%); 10b: docs/EXPERIMENTS_alexnet.md:76-79's
# AlexNet recipe (gradual 90% in 128x128 blocks, b64, SGD 0.01, xavier),
# its 1200 + 800 + 500 steps cut to 60 + 60 + 20 (7 mask recomputes;
# ``--examples-full`` runs the whole recipe); 10d at 100 classes, as the
# JAX script
EX_LENET = ["--model", "lenet", "--iters", "800", "--sparsities",
            "0.7,0.8,0.9", "--modes", "oneshot,deploy"]
EX_ALEXNET = ["--model", "alexnet", "--block", "128,128", "--sparsities",
              "0.9", "--modes", "gradual", "--batch", "64", "--base_lr",
              "0.01", "--filler", "xavier"]
EX_ALEXNET_SHORT = ["--iters", "60", "--gradual_iters", "60",
                    "--finetune_iters", "20"]
EX_ALEXNET_FULL = ["--iters", "1200", "--gradual_iters", "800",
                   "--finetune_iters", "500"]
EX_DENSE_MIN = 0.95
# two of the 256 test digits; the targets' element share (partial edge
# blocks make a block row's achieved sparsity differ from its block share)
EX_DELTA, EX_SPARSITY_TOL = 2 / 256, 0.01
EX_SURGERY_CLASSES = 100
EX_BUDGET_S = 90

# phase 11: the port's bench (caffe_escoin_tpu_torch/bench.py) called in
# process as a user runs it, with its own autotune table: (label, argv, the
# keys its line must have beyond bench.py's e2e / per-layer / fc / halo /
# batch-curve keys, which BENCH_KEYS lists, plus "device"); every run but
# --halo appends to BENCH_ROWS, which phase 12 renders with the halo rows
BENCH_AUTOTUNE_CACHE = "build/bench_autotune.json"
BENCH_ROWS = "build/BENCH_SWEEP.jsonl"
BENCH_E2E_KEYS = {"metric", "value", "unit", "batch", "vs_baseline",
                  "speedup_vs_dense_f32", "t_dense_f32_ms", "t_dense_bf16_ms",
                  "t_sparse_ms", "fused", "autotune", "packed", "s2d",
                  "weights_as_args"}
BENCH_KEYS = {  # bench.py :585-613, :268-277, :381-389, :763-766, :840-845
    "e2e": BENCH_E2E_KEYS,
    "per_layer": {"metric", "value", "unit", "batch", "vs_baseline",
                  "speedup_vs_dense_f32", "gnnz_per_s", "autotune"},
    "fc": {"metric", "value", "unit", "batch", "vs_baseline",
           "speedup_vs_dense_f32"},
    "halo": {"metric", "value", "unit", "vs_baseline", "rows"},
    "batch_curve": {"metric", "value", "unit", "vs_baseline", "rows"},
}
BENCH_RUNS = [
    ("bare", [], "e2e", {"calibrated", "calibration", "buckets"}),
    ("bare weights-as-args", ["--weights-as-args"], "e2e",
     {"calibrated", "calibration", "buckets"}),
    ("e2e xbsp-arm fused", ["--e2e", "--xbsp-arm", "fused", "--no-autotune",
                            "--batch", "32"], "e2e", {"xbsp_arm"}),
    ("per-layer b32", ["--per-layer", "--batch", "32"], "per_layer", set()),
    ("fc vgg16 b16", ["--fc", "--model", "vgg16"], "fc", set()),
    ("halo b16", ["--halo"], "halo", set()),
    ("batch-curve", ["--batch-curve"], "batch_curve", set()),
    ("e2e unstructured", ["--e2e", "--granularity", "unstructured",
                          "--batch", "32"], "e2e", set()),
]
BENCH_LOGITS = "fc1000"
BENCH_BUDGET_S = 300
# phase 13: the probes (caffe_escoin_tpu_torch/experiments/), each called in
# process as ``main(argv)`` at its script's shapes, counts cut to fit the
# budget, with an autotune table of the phase's own (emptied first); each
# appends its rows to build/experiments/<name>.jsonl (emptied first), its
# stdout in build/experiments_<i>.log
EXP_AUTOTUNE_CACHE = "build/experiments_autotune.json"
EXP_RUNS = [  # (label, module, argv)
    ("opprofile resnet50", "opprofile", ["--net", "resnet50"]),
    ("opprofile googlenet", "opprofile", ["--net", "googlenet"]),
    ("pool", "pool", []),
    ("k3", "k3", ["--shapes", "56,7"]),
    ("s2d", "s2d", []),
    ("wpack", "wpack", []),
    ("stability", "stability", ["--phase", "A,D", "--wall-iters", "50"]),
    ("rss_probe", "rss_probe", ["--variant", "train", "--iters", "200",
                                "--every", "50"]),
]
EXP_BUDGET_S = 150


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0].strip()


def _ptxas_summary(log) -> str:
    """One summary per kernel template, Rows policy, operand type and
    split-K instance: the entries of nvcc's -Xptxas -v report, grouped by
    the names in their mangled symbol. A Rows policy over f32 operands
    mangles as ``...RowsIfE`` (the bf16 one as ``__nv_bfloat16`` or a
    back-reference); its family is named ``f32``."""
    fams = collections.defaultdict(lambda: dict(n=0, regs=[], smem=[],
                                                spill=0))
    for entry in re.split(r"Compiling entry function", log)[1:]:
        symbol = entry.split("\n", 1)[0]
        kern = re.search(r"\d([a-z][a-z_]*_kernel)I", symbol)
        rows = re.search(r"\d([A-Za-z]+Rows)", symbol)
        if kern and kern.group(1) == "lrn_kernel":
            fam = fams["lrn_kernel<" + ("f32" if "lrn_kernelIf" in symbol
                                        else "bf16") + ">"]
        elif kern and (kern.group(1).startswith("maxpool_")
                       or kern.group(1) in ("conv_epilogue_kernel",
                                            "stem_conv_kernel")):
            fam = fams[kern.group(1) + "<" + ("f32" if "3F32" in symbol
                                              else "bf16") + ">"]
        else:
            fam = fams[(kern.group(1) if kern else "other")
                       + (f"<{rows.group(1)}" if rows else "<")
                       + (", f32" if "RowsIfE" in symbol else "")
                       + (", split>" if "Lb1E" in symbol else ">")]
        fam["n"] += 1
        fam["regs"] += [int(r) for r in
                        re.findall(r"Used (\d+) registers", entry)]
        fam["smem"] += [int(b) for b in
                        re.findall(r"(\d+) bytes smem", entry)] or [0]
        fam["spill"] += sum(int(b) for b in
                            re.findall(r"(\d+) bytes spill", entry))
    return "; ".join(
        f"{k} {f['n']} instances, {min(f['regs'])}-{max(f['regs'])} "
        f"registers, {min(f['smem'])}-{max(f['smem'])} B static shared, "
        f"{f['spill']} B spilled" for k, f in fams.items())


def _time_ms(fn, args, iters=TIMED_ITERS):
    """Mean ms per call over ``iters`` calls cycling ``args``, CUDA events,
    after one warm-up pass over every argument."""
    import torch

    for a in args:
        fn(a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(args[i % len(args)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, args, iters=TIMED_ITERS):
    """Mean device ms per call: ``iters`` calls cycling ``args`` captured in
    one CUDA graph, replayed between CUDA events after warm-up, the median
    of GRAPH_REPLAYS replays. The host's dispatch drops out, so a short
    kernel is timed, not the Python that launches it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in args:
            fn(a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(args[i % len(args)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return float(np.median(times)) / iters


def _layer_split(layers, fwd, x):
    """Device ms of each layer of one sparse forward on ``x``: every layer
    replayed alone as a CUDA graph (``_graph_ms``) on the inputs it got in
    that forward (recorded by module hooks)."""
    import torch

    calls, hooks = [], []
    for layer in layers:
        hooks.append(layer.register_forward_pre_hook(
            lambda mod, args: calls.append((mod, args))))
    try:
        fwd(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    with torch.inference_mode():
        return {mod.spec.name: _graph_ms(lambda a, mod=mod: mod(*a), [args],
                                         iters=5)
                for mod, args in calls}


def _bound(nbytes, flops, rates=BOUND_RATES):
    """(ms, what sets it): the least time the card could take for work
    that moves ``nbytes`` and does ``flops`` operations at ``rates`` (bf16
    tensor-core FLOP/s; ``BOUND_RATES_F32`` for f32 multiplies)."""
    ms = {k: v / rates[k] * 1e3
          for k, v in (("bytes", nbytes), ("operations", flops))}
    by = max(ms, key=ms.get)
    return ms[by], by


def _routed(launches) -> dict:
    """The route kernels' entries of a ``Net.launches`` count, those it
    launches."""
    return {k: n for k, n in launches.items() if k in KERNELS and n}


def _bf16_ulps(out, ref) -> float:
    """The largest |out - ref| in bf16 spacings at ref (inf where ref is 0
    and out is not)."""
    import torch

    out, ref = out.float(), ref.float()
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), e - 8)
    diff = (out - ref).abs()
    return float(torch.where(ref == 0, diff * float("inf"),
                             diff / ulp).nan_to_num(0.0).max())


def _phase_lrn(tag, dev, r):
    """Phase 3l (see the module docstring); its errors, times and bounds
    summed into ``r``, the LRN kernel's results."""
    import torch
    import torch.nn.functional as F

    from caffe_escoin_tpu_torch.kernels import lrn

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    arms = {
        "kernel": lambda x: lrn.lrn(x, **LRN_PARAMS),
        "plain": lambda x: lrn.lrn_plain(x, **LRN_PARAMS),
        "library": lambda x: F.local_response_norm(
            x.permute(0, 3, 1, 2), LRN_PARAMS["local_size"],
            alpha=LRN_PARAMS["alpha"], beta=LRN_PARAMS["beta"],
            k=LRN_PARAMS["k"]),
    }
    for label, shape in LRN_SHAPES:
        xs = [(torch.randn(shape, generator=gen, device=dev) * LRN_SCALE
               ).bfloat16() for _ in range(N_INPUTS)]
        launches = lrn.launches
        with torch.inference_mode():
            out = arms["kernel"](xs[0])
            torch.cuda.synchronize()
            ref = arms["plain"](xs[0])
            ulps = _bf16_ulps(out, ref)
        r["err"] = max(r["err"], (out.float() - ref.float()).abs().max()
                       .item())
        ok = lrn.launches == launches + 1 and ulps <= 1
        print(f"parity cet_lrn {label}: {ulps:.2f} bf16 ulp of the plain "
              f"version at most (bound 1), {lrn.launches - launches} launch "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"cet_lrn {label}: disagrees with its plain "
                             f"version or did not launch once")
        with torch.inference_mode():
            graph = {arm: _graph_ms(fn, xs) for arm, fn in arms.items()}
            eager = {arm: _time_ms(fn, xs) for arm, fn in arms.items()}
        nbytes = 2 * xs[0].numel() * xs[0].element_size()
        bound_ms, bound_by = _bound(nbytes, 0)
        for arm in arms:
            key = "ms" if arm == "kernel" else f"{arm}_ms"
            r[key] += eager[arm]
            r["graph_" + key] += graph[arm]
        r["bound_ms"] += bound_ms
        r["bound"]["bytes"] += bound_ms  # all of it: no operations
        print(f"time cet_lrn {label}, as a CUDA graph (eager): " + ", ".join(
            f"{arm} {graph[arm]:.4f} ({eager[arm]:.4f}) ms" for arm in arms)
              + f"; bound {bound_ms * 1e3:.1f} us ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB at {BOUND_RATES['bytes'] / 1e12:.2f} "
              f"TB/s), kernel graph at {bound_ms / graph['kernel']:.1%} of "
              f"it, {graph['kernel'] / graph['library']:.2f}x the library "
              f"{tag}")
        del xs, out, ref


def _phase_maxpool(tag, dev, r):
    """Phase 3m (see the module docstring); its errors, times and bounds
    summed into ``r``, the max-pool kernel's results."""
    import torch
    import torch.nn.functional as F

    from caffe_escoin_tpu_torch.kernels import maxpool
    from caffe_escoin_tpu_torch.ops.pool import _pooled_size

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    for label, shape, k, s, p in MAXPOOL_SHAPES:
        args = ((k, k), (s, s), (p, p),
                tuple(_pooled_size(n, k, s, p, True) for n in shape[1:3]))
        arms = {
            "kernel": lambda x, a=args: maxpool.max_pool(x, *a),
            "plain": lambda x, a=args: maxpool.max_pool_plain(x, *a),
            "library": lambda x, k=k, s=s, p=p: F.max_pool2d(
                x.permute(0, 3, 1, 2), k, s, padding=p, ceil_mode=True),
        }
        xs = [torch.randn(shape, generator=gen, device=dev).bfloat16()
              for _ in range(N_INPUTS)]
        launches = maxpool.launches
        with torch.inference_mode():
            out = arms["kernel"](xs[0])
            torch.cuda.synchronize()
            ref = arms["plain"](xs[0])
            lib = arms["library"](xs[0]).permute(0, 2, 3, 1)
        r["err"] = max(r["err"], (out.float() - ref.float()).abs().max()
                       .item())
        ok = (maxpool.launches == launches + 1 and torch.equal(out, ref)
              and torch.equal(lib, ref))
        print(f"parity cet_maxpool {label}: the plain version's values "
              f"(torch.equal, and the library's), "
              f"{maxpool.launches - launches} launch "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"cet_maxpool {label}: disagrees with its plain "
                             f"version or did not launch once")
        with torch.inference_mode():
            graph = {arm: _graph_ms(fn, xs) for arm, fn in arms.items()}
            eager = {arm: _time_ms(fn, xs) for arm, fn in arms.items()}
        nbytes = (xs[0].numel() + out.numel()) * xs[0].element_size()
        bound_ms, bound_by = _bound(nbytes, 0)
        for arm in arms:
            key = "ms" if arm == "kernel" else f"{arm}_ms"
            r[key] += eager[arm]
            r["graph_" + key] += graph[arm]
        r["bound_ms"] += bound_ms
        r["bound"]["bytes"] += bound_ms  # all of it: no operations
        print(f"time cet_maxpool {label}, as a CUDA graph (eager): "
              + ", ".join(f"{arm} {graph[arm]:.4f} ({eager[arm]:.4f}) ms"
                          for arm in arms)
              + f"; bound {bound_ms * 1e3:.1f} us ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB at {BOUND_RATES['bytes'] / 1e12:.2f} "
              f"TB/s), kernel graph at {bound_ms / graph['kernel']:.1%} of "
              f"it, {graph['kernel'] / graph['library']:.2f}x the library "
              f"{tag}")
        del xs, out, ref, lib


def _phase_conv_epilogue(tag, dev, r):
    """Phase 3e (see the module docstring); its errors, times and bounds
    summed into ``r``, the epilogue kernel's results."""
    import torch

    from caffe_escoin_tpu_torch.kernels import conv_epilogue

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for label, shape in EPILOGUE_SHAPES:
        c = shape[3]
        b = (torch.randn(c, generator=gen, device=dev) * 0.1).bfloat16()
        arms = {
            # in place over the map, as conv2d_dense runs it
            "kernel": lambda y, b=b: conv_epilogue.conv_epilogue(
                y, b, relu=True),
            "plain": lambda y, b=b: conv_epilogue.epilogue_plain(
                y, b, relu=True),
            "library": lambda y, b=b, c=c: torch.relu(
                y.permute(0, 3, 1, 2).add_(b.view(1, c, 1, 1))),
        }
        xs = [torch.randn(shape, generator=gen, device=dev).bfloat16()
              for _ in range(N_INPUTS)]
        launches = conv_epilogue.launches
        with torch.inference_mode():
            ref = arms["plain"](xs[0])
            lib = arms["library"](xs[0].clone()).permute(0, 2, 3, 1)
            out = arms["kernel"](xs[0].clone())
            torch.cuda.synchronize()
        r["err"] = max(r["err"], (out.float() - ref.float()).abs().max()
                       .item())
        ok = (conv_epilogue.launches == launches + 1
              and torch.equal(out.view(torch.int16), ref.view(torch.int16))
              and torch.equal(lib.contiguous().view(torch.int16),
                              ref.view(torch.int16)))
        print(f"parity cet_conv_epilogue {label} +bias +relu: the plain "
              f"version's bits (and the library's), "
              f"{conv_epilogue.launches - launches} launch "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"cet_conv_epilogue {label}: disagrees with its "
                             f"plain version or did not launch once")
        with torch.inference_mode():
            graph = {arm: _graph_ms(fn, xs) for arm, fn in arms.items()}
            eager = {arm: _time_ms(fn, xs) for arm, fn in arms.items()}
        nbytes = 2 * xs[0].numel() * xs[0].element_size()
        bound_ms, bound_by = _bound(nbytes, 0)
        for arm in arms:
            key = "ms" if arm == "kernel" else f"{arm}_ms"
            r[key] += eager[arm]
            r["graph_" + key] += graph[arm]
        r["bound_ms"] += bound_ms
        r["bound"]["bytes"] += bound_ms  # all of it: no operations
        print(f"time cet_conv_epilogue {label} +bias +relu, as a CUDA graph "
              f"(eager): " + ", ".join(
                  f"{arm} {graph[arm]:.4f} ({eager[arm]:.4f}) ms"
                  for arm in arms)
              + f"; bound {bound_ms * 1e3:.1f} us ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB at {BOUND_RATES['bytes'] / 1e12:.2f} "
              f"TB/s), kernel graph at {bound_ms / graph['kernel']:.1%} of "
              f"it, {graph['kernel'] / graph['library']:.2f}x the library "
              f"{tag}")
        del xs, out, ref, lib


def _phase_stem_conv(tag, dev, r):
    """Phase 3s (see the module docstring); its errors, times and bounds
    summed into ``r``, the stem kernel's results."""
    import torch
    import torch.nn.functional as F

    from caffe_escoin_tpu_torch.kernels import conv_epilogue, stem_conv

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for label, shape, k, s, p, cout in STEM_SHAPES:
        c = shape[3]
        wt = (torch.randn((k, k, c, cout), generator=gen, device=dev)
              * (2.0 / (k * k * c)) ** 0.5).bfloat16()
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        b16 = b.bfloat16()
        geo = dict(stride=(s, s), padding=(p, p))
        memo = {}

        def former(x, wt=wt, b16=b16, geo=geo):
            # conv2d_dense before the stem kernel: cuDNN without the bias,
            # then the epilogue kernel in place
            y = F.conv2d(x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                         None, **geo).permute(0, 2, 3, 1)
            return conv_epilogue.conv_epilogue(y, b16, relu=True)

        arms = {
            "kernel": lambda x, wt=wt, b=b, geo=geo, memo=memo:
                stem_conv.stem_conv(x, wt, b, relu=True, memo=memo, **geo),
            "plain": lambda x, wt=wt, b=b, geo=geo: stem_conv.stem_plain(
                x, wt, b, relu=True, **geo),
            "library": former,
        }
        xs = [torch.randn(shape, generator=gen, device=dev).bfloat16()
              for _ in range(N_INPUTS)]
        launches = stem_conv.launches
        with torch.inference_mode():
            ref = arms["plain"](xs[0])
            out = arms["kernel"](xs[0])
            torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        bound_err = PARITY_REL * ref.float().abs().max().item() + PARITY_ABS
        r["err"] = max(r["err"], err)
        ok = (stem_conv.launches == launches + 1 and err <= bound_err
              and bool(torch.isfinite(out).all()))
        print(f"parity cet_stem_conv {label} +bias +relu: max_abs_err "
              f"{err:.3e} (bound {bound_err:.3e}) against its plain version, "
              f"{stem_conv.launches - launches} launch "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"cet_stem_conv {label}: disagrees with its "
                             f"plain version or did not launch once")
        with torch.inference_mode():
            graph = {arm: _graph_ms(fn, xs) for arm, fn in arms.items()}
            eager = {arm: _time_ms(fn, xs) for arm, fn in arms.items()}
        m = out.numel() // cout
        nbytes = 2 * (xs[0].numel() + wt.numel() + out.numel())
        flops = 2 * m * cout * k * k * c
        bound_ms, bound_by = _bound(nbytes, flops)
        for arm in arms:
            key = "ms" if arm == "kernel" else f"{arm}_ms"
            r[key] += eager[arm]
            r["graph_" + key] += graph[arm]
        r["bound_ms"] += bound_ms
        r["bound"][bound_by] += bound_ms
        print(f"time cet_stem_conv {label} +bias +relu, as a CUDA graph "
              f"(eager): " + ", ".join(
                  f"{arm} {graph[arm]:.4f} ({eager[arm]:.4f}) ms"
                  for arm in arms)
              + f"; bound {bound_ms * 1e3:.1f} us ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), kernel "
              f"graph at {bound_ms / graph['kernel']:.1%} of it, "
              f"{graph['kernel'] / graph['library']:.2f}x the former "
              f"cuDNN + epilogue {tag}")
        del xs, out, ref


def _nopad(fn, x):
    """``fn(x)`` with ``CESCOIN_XBSP_NOPAD=1``: the XBSP arms' pad-free
    slab form, which they read per call."""
    os.environ["CESCOIN_XBSP_NOPAD"] = "1"
    try:
        return fn(x)
    finally:
        del os.environ["CESCOIN_XBSP_NOPAD"]


def _check_arms(net, params, shapes, measured):
    """(keys, keys with "fused"): every arm competed on every measured key,
    a conv's ``ops.conv.conv_arms`` (the fused kernel wherever
    ``fused_gate`` admits the shape), a sparse fc's ``ops.linear.fc_arms``.
    Each key is mapped back to its conv as the dispatcher forms it (a
    strided 1x1 conv on its subsampled map), or to its fc; raises
    SystemExit otherwise."""
    import torch

    from caffe_escoin_tpu_torch.engine import autotune
    from caffe_escoin_tpu_torch.ops import conv as conv_ops
    from caffe_escoin_tpu_torch.ops import linear as linear_ops
    from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight

    dtype = net.policy.compute_dtype or torch.float32
    seen, n_fused = set(), 0
    for layer, in_shapes in net.walk_shapes(shapes):
        al = params.get(layer.spec.name)
        if (layer.spec.type == "InnerProduct"
                and linear_ops.runs_sparse(al, layer.policy)):
            key = autotune.fc_cache_key(al.bsc, in_shapes[0][0], dtype,
                                        net.policy.mxu_dtype)
            want = set(linear_ops.fc_arms(al.bsc, net.policy))
            if key in measured and key not in seen:
                seen.add(key)
                if set(measured[key]) != want:
                    raise SystemExit(f"autotune: {layer.spec.name} measured "
                                     f"{sorted(measured[key])}, expected "
                                     f"{sorted(want)}")
            continue
        if (layer.spec.type not in ("Convolution", "ConvolutionReLU")
                or not isinstance(al, AlignedConvWeight) or al.bsc is None):
            continue
        # the geometry the conv runs with (a packed conv's packed stride
        # and padding)
        in_shape = layer._in_shape(in_shapes[0])  # a folded stem's s2d grid
        stride, pad, dil = (tuple(g) for g in layer._geometry(in_shape))
        x = torch.empty(in_shape, dtype=dtype, device="meta")
        if stride != (1, 1) and al.kernel_shape == (1, 1):
            x = conv_ops._subsampled(x, stride, pad)
            stride, pad = (1, 1), (0, 0)
        key = autotune.cache_key(al, x.shape, stride, pad, dil, dtype,
                                 net.policy.mxu_dtype)
        if key not in measured or key in seen:
            continue
        seen.add(key)
        want = set(conv_ops.conv_arms(x, al, stride=stride, padding=pad,
                                      dilation=dil, policy=net.policy))
        n_fused += "fused" in want
        if set(measured[key]) != want:
            raise SystemExit(f"autotune: {layer.spec.name} measured "
                             f"{sorted(measured[key])}, expected "
                             f"{sorted(want)}")
    if seen != set(measured):
        raise SystemExit(f"autotune: {len(set(measured) - seen)} measured "
                         f"keys belong to no conv of the net")
    return len(seen), n_fused


def _prune(net, params, keep_norm=False, block=BLOCK):
    """bench.py's pruning: conv and fc weights at SPARSITY in ``block``
    blocks, or element-wise with ``block=None`` (``--granularity
    unstructured``). The stem (3 input channels) stays dense.
    ``keep_norm`` scales each pruned weight back to its Frobenius norm,
    which bench.py does not: it keeps the signal alive through VGG-16's
    sixteen pruned layers."""
    import torch

    from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,
                                                      prune_conv_weight,
                                                      prune_magnitude)

    out = dict(params)
    for layer in net.layers:
        name, kind = layer.spec.name, layer.spec.type
        if name not in out or kind not in ("Convolution", "ConvolutionReLU",
                                           "InnerProduct"):
            continue
        q = dict(out[name])
        w = q["w"].numpy()
        if kind == "InnerProduct":
            wp = (prune_magnitude(w, SPARSITY) if block is None
                  else prune_blocks(w, SPARSITY, block))
        elif w.shape[2] >= 32:
            wp = prune_conv_weight(w, SPARSITY, block)
        else:
            continue
        if keep_norm:
            wp = wp * np.float32(np.linalg.norm(w) / np.linalg.norm(wp))
        q["w"] = torch.from_numpy(wp)
        out[name] = q
    return out


def _run_entry(fn, argv, log):
    """(exit code, standard output) of one entry point called in process,
    ``fn(argv)``; the output also goes to ``log`` (under build/). An entry
    that raises prints what it wrote first."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
    except BaseException:
        print(buf.getvalue(), file=sys.stderr)
        raise
    finally:
        with open(log, "w") as fh:
            fh.write(buf.getvalue())
    return rc or 0, buf.getvalue()


def _report_rows(text, specs):
    """The per-layer rows of ``format_report``'s text, in the net's layer
    order, as (name, type, category, fwd ms, bwd ms). A row starts with the
    layer's name, which may run into the type column, so each is cut at
    the name the net gives it."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("layer "))
    rows = []
    for spec, line in zip(specs, lines[start + 1:]):
        if not line.startswith(spec.name):
            raise SystemExit(f"cli time: row {line!r} is not layer "
                             f"{spec.name}")
        kind, cat, fwd, bwd = line[len(spec.name):].split()[:4]
        rows.append((spec.name, kind, cat, float(fwd), float(bwd)))
    if len(rows) != len(specs):
        raise SystemExit(f"cli time: {len(rows)} rows for {len(specs)} "
                         f"layers")
    return rows


def _phase_cli(mods, tag):
    """Phase 6: the reference's entry points (``tools/cli.py``,
    ``tools/parity.py``) called in process on the card at CLI_MODEL b32,
    full depth and width, f32, unfused, as the JAX command line runs it.
    Every launch counter must read 0 over it: the command line's policy
    runs the XBSP arms (torch ops) and no hand kernel."""
    import argparse

    import torch

    from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                       ExecutionPolicy)
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, params_to
    from caffe_escoin_tpu_torch.tools import cli, parity
    from caffe_escoin_tpu_torch.tools.caffemodel import (assign_to_params,
                                                         batchnorm_state,
                                                         load_caffemodel)
    from caffe_escoin_tpu_torch.tools.prototxt import load_net
    from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight

    t_phase = time.perf_counter()
    os.makedirs("build", exist_ok=True)
    model, batch = CLI_MODEL, CLI_BATCH
    stem = os.path.join("build", f"cli_{model}")
    common = ["--model", model, "--batch", str(batch), "--num-classes",
              str(CLI_CLASSES)]
    sparse = ["--sparsity", str(SPARSITY), "--block-shape", *map(str, BLOCK)]

    # 6.1 device_query
    _, out = _run_entry(cli.main, ["device_query"], f"{stem}_query.log")
    print("cli device_query: " + "; ".join(
        ln.strip() for ln in out.splitlines()) + f" {tag}")
    for m in mods.values():
        m.reset_counts()

    # 6.2 parity: the three sparse modes against LOWERED_GEMM
    t0 = time.perf_counter()
    rc, out = _run_entry(parity.main, common + sparse + ["--batches", "2"],
                         f"{stem}_parity.log")
    lines = [ln for ln in out.splitlines() if "max|dprob|" in ln]
    for ln in lines:
        print(f"cli parity {model} b{batch}: {ln.strip()} {tag}")
    print(f"cli parity: exit {rc}, {time.perf_counter() - t0:.1f} s {tag}")
    if rc != 0 or len(lines) != 3:
        raise SystemExit(f"parity exited {rc} with {len(lines)} mode lines")

    # 6.3 model I/O: the zoo net's random weights through a prototxt and a
    # caffemodel, back into a net built from that prototxt
    t0 = time.perf_counter()
    for cmd, suffix in (("export_prototxt", ".prototxt"),
                        ("export_caffemodel", ".caffemodel")):
        rc, out = _run_entry(cli.main, [cmd, *common, "--output",
                                        stem + suffix], f"{stem}_{cmd}.log")
        if rc != 0:
            raise SystemExit(f"cli {cmd} exited {rc}")
        print(f"cli {cmd}: {out.strip().splitlines()[-1]}, "
              f"{os.path.getsize(stem + suffix)} bytes {tag}")
    prune_args = argparse.Namespace(sparsity=SPARSITY, block_shape=BLOCK)
    policy = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK)
    dev = torch.device("cuda", torch.cuda.current_device())
    shapes = {"data": (batch,) + tuple(ZOO[model][1]["data"][1:])}
    zoo_net = Net(ZOO[model][0](num_classes=CLI_CLASSES), policy=policy)
    zoo_params = zoo_net.init(torch.Generator().manual_seed(SEED), shapes)
    specs, io_shapes, _ = load_net(stem + ".prototxt", batch=batch)
    io_net = Net(specs, policy=policy)
    # another seed: only the imported weights can make the two nets agree
    io_params = io_net.init(torch.Generator().manual_seed(SEED + 1),
                            io_shapes)
    loaded = load_caffemodel(stem + ".caffemodel")
    io_params = assign_to_params(io_net, io_params, loaded,
                                 log=lambda *_: None)
    io_net.state0.update(batchnorm_state(loaded))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = [torch.randn(shapes["data"], generator=gen, device=dev)
          for _ in range(N_INPUTS)]
    logits, aligned = [], []
    with contextlib.redirect_stdout(io.StringIO()):
        for net, prm in ((zoo_net, zoo_params), (io_net, io_params)):
            aligned.append(net.weight_align(
                cli._maybe_prune(net, prm, prune_args)))
            fwd = net.inference_fn(params_to(aligned[-1], dev),
                                   state=params_to(net.state0, dev),
                                   return_blobs=True)
            logits.append([fwd({"data": x})["fc1000"] for x in xs])
    # the convs whose aligned weight holds a BSC: `cli time` gives them no
    # backward (the JAX rule); a conv that pruning leaves dense has one
    bsc_convs = {n for n, a in aligned[0].items()
                 if isinstance(a, AlignedConvWeight) and a.bsc is not None}
    peak = max(t.abs().max().item() for t in logits[0])
    diff = max((a - b).abs().max().item() for a, b in zip(*logits))
    ok = (diff <= 1e-6 * peak and peak > 0
          and all(torch.isfinite(t).all() for t in logits[1]))
    print(f"cli model I/O {model} b{batch}: {len(specs)} layers from the "
          f"prototxt, {len(loaded)} weighted layers from the caffemodel; "
          f"fc1000 logits of the reloaded net vs the zoo net on "
          f"{N_INPUTS} inputs: max|diff| {diff:.3e} (limit 1e-6 x "
          f"max|logit| {peak:.3e}) {'ok' if ok else 'FAIL'}, "
          f"{time.perf_counter() - t0:.1f} s {tag}")
    if not ok:
        raise SystemExit("the prototxt + caffemodel round trip changed the "
                         "logits")
    del logits, aligned, xs, zoo_params, io_params, loaded

    # 6.4 cli test on the exported files, SCONV_PAR then LOWERED_SPARSE
    for mode in (3, 1):
        t0 = time.perf_counter()
        rc, out = _run_entry(cli.main, [
            "test", "--model", stem + ".prototxt", "--weights",
            stem + ".caffemodel", "--batch", str(batch), "--conv_mode",
            str(mode), *sparse, "--iterations", str(CLI_ITERS)],
            f"{stem}_test{mode}.log")
        its = [ln.split("forward ")[1] for ln in out.splitlines()
               if ln.startswith("iteration ")]
        avg = [ln for ln in out.splitlines() if ln.startswith("average")]
        print(f"cli test {model} b{batch} --conv_mode {mode} "
              f"({ConvMode(mode).name}): forward per iteration "
              f"{', '.join(its)}; {avg[0] if avg else '?'}; exit {rc}, "
              f"{time.perf_counter() - t0:.1f} s {tag}")
        if rc != 0 or len(its) != CLI_ITERS:
            raise SystemExit(f"cli test --conv_mode {mode} exited {rc}")

    # 6.5 cli time with the backward column
    t0 = time.perf_counter()
    rc, out = _run_entry(cli.main, [
        "time", *common, "--conv_mode", "3", *sparse, "--iterations",
        str(CLI_TIME_ITERS)], f"{stem}_time.log")
    if rc != 0:
        raise SystemExit(f"cli time exited {rc}")
    for ln in out.splitlines():
        if ln.startswith(("[totals]", "[backward]")):
            print(f"cli time {model} b{batch} SCONV_PAR: {ln} {tag}")
    rows = _report_rows(out, ZOO[model][0](num_classes=CLI_CLASSES))
    print(f"cli time {model}: five slowest forwards (name, type, fwd ms, "
          f"bwd ms): " + ", ".join(
              f"{n} {k} {f:.3f} {b:.3f}"
              for n, k, _, f, b in sorted(rows, key=lambda r: -r[3])[:5])
          + f"; {len(rows)} rows, {time.perf_counter() - t0:.1f} s {tag}")
    wrong = [n for n, _, _, _, b in rows if (b == 0) != (n in bsc_convs)]
    n_timed = len(rows) - len(bsc_convs)
    print(f"cli time {model}: backward 0 on the {len(bsc_convs)} convs "
          f"aligned with a BSC, timed on the other {n_timed} rows: "
          f"{'ok' if not wrong else 'FAIL ' + str(wrong)} {tag}")
    if wrong:
        raise SystemExit(f"cli time: backward column wrong for {wrong}")

    launches = {k: m.launches for k, m in mods.items()}
    print(f"cli launches over parity, model I/O, test and time: {launches} "
          f"(expected none: the command line's policy runs the XBSP arms) "
          f"{tag}")
    if any(launches.values()):
        raise SystemExit("the command line launched a hand kernel")
    print(f"cli phase: {time.perf_counter() - t_phase:.1f} s wall {tag}")


def _train_select(name, key, leaf):
    """examples/train_eval_sparse.py's pruning select: the weights of the
    convs with 16 or more input channels per group and of the fc layers
    (conv1 stays dense)."""
    if key != "w":
        return False
    shp = np.shape(leaf)
    return shp[2] >= 16 if len(shp) == 4 else len(shp) == 2


def _xavier(specs):
    """The specs with every weight filler set to xavier, as
    examples/train_eval_sparse.py's ``--filler xavier``."""
    import dataclasses

    return [dataclasses.replace(sp, params={**sp.params, "weight_filler":
                                            {"type": "xavier"}})
            if "weight_filler" in sp.params else sp for sp in specs]


def _zero_block_share(w, block):
    """(share of all-zero blocks, block count) of a weight as the pruning
    ranks it: a conv's per-offset (Cin, Cout) planes, an fc's matrix, each
    zero-padded to whole ``block`` tiles."""
    planes = w.reshape(-1, w.shape[-2], w.shape[-1])
    n, rows, cols = planes.shape
    bm, bk = block
    padded = np.zeros((n, -(-rows // bm) * bm, -(-cols // bk) * bk),
                      w.dtype)
    padded[:, :rows, :cols] = planes
    live = (padded.reshape(n, padded.shape[1] // bm, bm,
                           padded.shape[2] // bk, bk) != 0).any(axis=(2, 4))
    return float((~live).mean()), live.size


def _step_against_cpu(model, batch, dev, tag):
    """Phase 7b: one SGD step of ``model`` at ``batch`` on the card and on
    the CPU from the same params (the Solvers' CPU init generators share
    the seed) and batch, and the same step on the CPU in f64 as the
    reference: the loss and the BatchNorm state held to STEP_LOSS_REL and
    STEP_BN_TOL, each param's update to the larger of STEP_UPDATE_REL and
    twice the CPU f32 update's distance from the f64 one. A conv bias that
    feeds a BatchNorm has a zero gradient in exact arithmetic (the mean is
    subtracted), so its update is rounding noise: it is held to max
    |update| <= 1e-6 on both instead."""
    import dataclasses

    import torch

    from caffe_escoin_tpu_torch.data.datasets import synthetic_source
    from caffe_escoin_tpu_torch.engine import solvers
    from caffe_escoin_tpu_torch.engine.solver import Solver
    from caffe_escoin_tpu_torch.engine.solvers import SolverConfig
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, params_to

    build, shapes = ZOO[model]
    specs = [dataclasses.replace(sp, params={**sp.params, "ratio": 0.0})
             if sp.type == "Dropout" else sp
             for sp in _xavier(build(include_loss=True, **(
                 {"num_classes": TRAIN_CLASSES} if model == "alexnet"
                 else {})))]
    shapes = {"data": (batch,) + tuple(shapes["data"][1:]),
              "label": (batch,)}
    src = synthetic_source(shapes["data"], num_classes=TRAIN_CLASSES
                           if model == "alexnet" else 10, seed=SEED + 3)
    data = src()
    # the convs whose output reaches a BatchNorm through pools only (a
    # per-channel shift passes max and average pooling unchanged)
    producer = {t: sp for sp in specs for t in sp.tops}
    noise = set()
    for sp in specs:
        if sp.type == "BatchNorm":
            src_sp = producer[sp.bottoms[0]]
            while src_sp.type == "Pooling":
                src_sp = producer[src_sp.bottoms[0]]
            if src_sp.type in ("Convolution", "ConvolutionReLU"):
                noise.add(src_sp.name)
    runs, t = [], []  # the card's, the CPU's, the CPU's in f64
    for where, dtype in ((dev, torch.float32), ("cpu", torch.float32),
                         ("cpu", torch.float64)):
        t0 = time.perf_counter()
        sol = Solver(Net(specs, phase="train"), SolverConfig(
            base_lr=0.01, momentum=0.9, weight_decay=5e-4), display=1,
            seed=SEED, device=where)
        sol.init(shapes)
        feed = data
        if dtype == torch.float64:  # the reference: the same step in f64
            sol.params = params_to(sol.params, "cpu", dtype)
            sol.state = solvers.init_state(sol.cfg, sol.params)
            feed = {**data, "data": data["data"].astype(np.float64)}
        before = {n: {k: v.detach().cpu().clone() for k, v in b.items()}
                  for n, b in sol.params.items()}
        logs = []
        sol.step(iter([feed]), 1, log=logs.append)
        loss = float(logs[-1].rsplit("loss = ", 1)[1])
        runs.append((loss, before, params_to(sol.params, "cpu"),
                     params_to(sol.net_state, "cpu")))
        t.append(time.perf_counter() - t0)
    (l_gpu, b_gpu, p_gpu, s_gpu), (l_cpu, b_cpu, p_cpu, s_cpu), \
        (_, b_ref, p_ref, _) = runs
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    # each param: the card against the CPU, held to STEP_UPDATE_REL or to
    # twice the CPU's own distance from the f64 step, whichever is larger
    # (AlexNet b8's conv1 weight gradient sums 24200 products per element
    # with much cancellation; the line prints the f32 updates' distances
    # from the f64 one)
    worst, noise_max, errs = None, 0.0, []
    for name, blobs in p_cpu.items():
        for k, w in blobs.items():
            if not torch.equal(b_gpu[name][k], b_cpu[name][k]):
                raise SystemExit(f"step {model}: {name}/{k} started from "
                                 f"other params on the two devices")
            d_cpu = w - b_cpu[name][k]
            d_gpu = p_gpu[name][k] - b_gpu[name][k]
            if name in noise and k == "b":
                noise_max = max(noise_max, d_cpu.abs().max().item(),
                                d_gpu.abs().max().item())
                continue
            d_ref = (p_ref[name][k] - b_ref[name][k]).double()
            rel = ((d_gpu - d_cpu).norm() / d_cpu.norm()).item()
            cpu_err = ((d_cpu.double() - d_ref).norm() / d_ref.norm()).item()
            gpu_err = ((d_gpu.double() - d_ref).norm() / d_ref.norm()).item()
            bound = max(STEP_UPDATE_REL, 2 * cpu_err)
            errs.append((f"{name}/{k}", cpu_err, gpu_err))
            if worst is None or rel / bound > worst[1] / worst[2]:
                worst = (f"{name}/{k}", rel, bound, cpu_err, gpu_err)
    bn_err = max(((s_gpu[n][k] - s_cpu[n][k]).abs().max()
                  / s_cpu[n][k].abs().max().clamp_min(1e-30)).item()
                 for n in s_cpu for k in s_cpu[n]) if s_cpu else 0.0
    ok = (loss_rel <= STEP_LOSS_REL and worst[1] <= worst[2]
          and bn_err <= STEP_BN_TOL and noise_max <= 1e-6)
    print(f"train step {model} b{batch}, card against CPU, one SGD step: "
          f"loss {l_gpu:.6g} / {l_cpu:.6g}, rel {loss_rel:.2e} (limit "
          f"{STEP_LOSS_REL:.0e}); the param nearest its bound {worst[0]}: "
          f"update rel L2 {worst[1]:.2e} (bound {worst[2]:.2e}; the CPU's "
          f"f32 update {worst[3]:.2e} and the card's {worst[4]:.2e} from "
          f"the f64 one); the f32 updates farthest from the f64 one, CPU "
          f"and card: " + ", ".join(
              f"{n} {c:.2e} {g:.2e}"
              for n, c, g in sorted(errs, key=lambda e: -max(e[1:]))[:3])
          + (f"; BatchNorm state rel max {bn_err:.2e} (limit "
             f"{STEP_BN_TOL:.0e}); pre-BatchNorm conv bias updates max "
             f"{noise_max:.1e} (limit 1e-6)" if s_cpu else "")
          + f"; {Net.num_params(p_cpu)} params; wall card {t[0]:.1f} s, "
          f"CPU {t[1]:.1f} s, CPU f64 {t[2]:.1f} s "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit(f"the card's {model} step differs from the CPU's")


def _phase_train(mods, tag, results, alexnet_graph_ms):
    """Phase 7: the training path on the card (f32, TF32 off), then the
    trained, pruned AlexNet deployed on the kernel routes; see the module
    docstring. Adds the deployment's launches to ``results``."""
    import collections

    import torch

    from caffe_escoin_tpu_torch.data.datasets import synthetic_source
    from caffe_escoin_tpu_torch.data.pipeline import PrefetchLoader
    from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                       ExecutionPolicy)
    from caffe_escoin_tpu_torch.engine.solver import Solver
    from caffe_escoin_tpu_torch.engine.solvers import SolverConfig
    from caffe_escoin_tpu_torch.kernels import (conv_epilogue, lrn, maxpool,
                                                stem_conv)
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
    from caffe_escoin_tpu_torch.tools import cli
    from caffe_escoin_tpu_torch.utils.benchmark import force_platform
    from caffe_escoin_tpu_torch.utils.pruning import PruningSchedule

    t_phase = time.perf_counter()
    dev = force_platform("auto")  # the card, TF32 off
    build, in_shapes = ZOO["alexnet"]
    specs = _xavier(build(num_classes=TRAIN_CLASSES, include_loss=True))
    shapes = {"data": (TRAIN_BATCH,) + tuple(in_shapes["data"][1:]),
              "label": (TRAIN_BATCH,)}

    # 7a. AlexNet b32 trained under the AGP block-pruning schedule
    solver = Solver(Net(specs, phase="train"), SolverConfig(
        base_lr=0.01, momentum=0.9, weight_decay=5e-4), display=1,
        test_net=Net(specs, phase="test"), test_iters=TRAIN_TEST_BATCHES,
        seed=SEED, device=dev)
    solver.init(shapes)
    solver.set_pruning_schedule(PruningSchedule(**TRAIN_SCHEDULE),
                                select=_train_select)
    print(f"train alexnet b{TRAIN_BATCH} {shapes['data'][1]}x"
          f"{shapes['data'][2]}, {TRAIN_CLASSES} classes, f32, xavier "
          f"fillers, SGD lr 0.01 momentum 0.9 weight decay 5e-4, "
          f"{Net.num_params(solver.params)} params; schedule "
          f"{TRAIN_SCHEDULE}, pruned: convs with cin >= 16 and the fcs "
          f"{tag}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    src = synthetic_source(shapes["data"], num_classes=TRAIN_CLASSES,
                           seed=SEED)
    steps, losses = [], []  # (step ms, batch wait ms) of steady steps
    held = torch.cuda.memory_allocated(dev)  # by the earlier phases
    with PrefetchLoader(src, device=dev) as loader:
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            batch = next(loader)  # the loader's wait stays off the events
            wait_ms = (time.perf_counter() - t0) * 1e3
            logs = []
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            solver.step(iter([batch]), 1, log=logs.append)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            loss = float(logs[-1].rsplit("loss = ", 1)[1])
            losses.append(loss)
            recomputed = solver.mask_update_s
            if recomputed is None and i > 0:  # step 0: first launches
                steps.append((ms, wait_ms))
            print(f"train step {i}: loss {loss:.6g}, {ms:.3f} ms between "
                  f"CUDA events around Solver.step, {wait_ms:.1f} ms host "
                  f"wait for the loader's batch"
                  + (f", masks recomputed ({logs[0].split(', ', 1)[1]}) in "
                     f"{recomputed:.3f} s host" if recomputed is not None
                     else ", masks unchanged") + f" {tag}")
            if not np.isfinite(loss):
                raise SystemExit(f"train step {i}: the loss is not finite")
        peak = torch.cuda.max_memory_allocated(dev) - held
        prof_batches = [next(loader) for _ in range(PROFILE_STEPS)]
    step_ms = [a for a, _ in steps]
    ips = TRAIN_BATCH * len(steps) / (sum(step_ms) / 1e3)
    ips_wall = TRAIN_BATCH * len(steps) / (sum(a + b for a, b in steps)
                                           / 1e3)
    print(f"train alexnet b{TRAIN_BATCH}: {ips:.1f} images/s over the "
          f"{len(steps)} steps after the first that recomputed no mask "
          f"(step mean {sum(step_ms) / len(steps):.3f} ms, min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}); {ips_wall:.1f} "
          f"images/s with the waits for the loader (synthetic_source on "
          f"one host thread); peak device memory of training "
          f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB the "
          f"earlier phases hold (max_memory_allocated); losses "
          f"{' '.join(f'{v:.4f}' for v in losses)} {tag}")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.step(iter(prof_batches), PROFILE_STEPS, log=lambda *_: None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / PROFILE_STEPS)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    print(f"train profile, {PROFILE_STEPS} steady steps under "
          f"torch.profiler: {wall_ms:.3f} ms per step on the host clock, "
          + (f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.0%}; "
             f"{len(kernels)} kernel names); the largest: " + ", ".join(
                 f"{k[:60]} {ms:.3f}" for k, ms in kernels[:6])
             if busy_ms else "the profiler saw no device time")
          + f" {tag}")
    pruned = []
    for name, blobs in solver.params.items():
        mask = solver.param_masks[name]["w"]
        if bool((mask == 1).all()):
            continue
        w = blobs["w"].detach().cpu().numpy()
        if (w[mask.cpu().numpy() == 0] != 0).any():
            raise SystemExit(f"train: {name} has a masked weight that is "
                             f"not 0")
        share, n = _zero_block_share(w, BLOCK)
        pruned.append((name, share, n))
        if abs(share - SPARSITY) > 1.0 / n:
            raise SystemExit(f"train: {name} has {share:.4f} of its {n} "
                             f"blocks zero, not {SPARSITY} within one block")
    print("train masks: pruned weights exactly 0; zero 128x128 blocks "
          + ", ".join(f"{n} {s:.4f} of {b}" for n, s, b in pruned)
          + f" (limit {SPARSITY} +- one block) ok {tag}")
    if [n for n, _, _ in pruned] != ["conv2", "conv3", "conv4", "conv5",
                                     "fc6", "fc7", "fc8"]:
        raise SystemExit(f"train: pruned {[n for n, _, _ in pruned]}")
    test_src = synthetic_source(shapes["data"], num_classes=TRAIN_CLASSES,
                                seed=SEED + 1)
    t0 = time.perf_counter()
    metrics = solver.test_all(iter([test_src() for _ in range(
        TRAIN_TEST_BATCHES)]), log=lambda *_: None)
    print(f"train test_all, {TRAIN_TEST_BATCHES} batches of "
          f"{TRAIN_BATCH} (random labels: chance is 1e-3 top-1): "
          + ", ".join(f"{k} {v:.4g}" for k, v in sorted(metrics.items()))
          + f", {time.perf_counter() - t0:.2f} s {tag}")
    if not all(np.isfinite(v) for v in metrics.values()) or \
            sorted(metrics) != ["accuracy", "accuracy_top5", "loss"]:
        raise SystemExit(f"train test_all gave {metrics}")
    trained = params_to(solver.params, "cpu")
    del solver, loader
    torch.cuda.empty_cache()

    # 7b. one step on the card held to the same step on the CPU
    for model, batch in STEP_NETS:
        _step_against_cpu(model, batch, dev, tag)

    # 7c. the trained weights deployed on the kernel routes
    pol_s = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                            compute_dtype=torch.bfloat16, cast_back=False,
                            use_xla_sparse=False)
    in_shape = {"data": shapes["data"]}
    net = Net(build(num_classes=TRAIN_CLASSES), policy=pol_s)
    net.init(torch.Generator().manual_seed(SEED), in_shape)
    fnet, fparams = fuse_inference(net, trained, state=net.state0)
    aligned = fnet.weight_align(fparams)
    routes = fnet.routes(aligned, in_shape)
    expect = fnet.launches(aligned, in_shape)
    fwd = fnet.inference_fn(params_to(aligned, dev, torch.bfloat16),
                            return_blobs=True)
    fwd_d = Net(fnet.specs, policy=ExecutionPolicy()).inference_fn(
        params_to(fparams, dev), return_blobs=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    inputs = [{"data": torch.randn(in_shape["data"], generator=gen,
                                   device=dev)} for _ in range(N_INPUTS)]
    net_mods = {**mods, LRN_KERNEL: lrn, MAXPOOL_KERNEL: maxpool,
                EPILOGUE_KERNEL: conv_epilogue, STEM_KERNEL: stem_conv}
    for m in net_mods.values():
        m.reset_counts()
    outs = [fwd(x)["fc8"].float().clone() for x in inputs]
    torch.cuda.synchronize()
    launches = {k: m.launches for k, m in net_mods.items()}
    print(f"deploy trained alexnet b{TRAIN_BATCH}: routes "
          f"{dict(collections.Counter(routes.values()))}; launches over "
          f"{N_INPUTS} forwards {launches} (expected {N_INPUTS} x "
          f"{dict(expect)}) {tag}")
    for name, n in launches.items():
        if (n != N_INPUTS * expect[name]
                or expect[name] != TRAINED_LAUNCHES[name]):
            raise SystemExit(f"deploy: {name} launched {n} times; routes "
                             f"name {expect[name]} per forward, expected "
                             f"{TRAINED_LAUNCHES[name]}")
        results[name]["launches"] += n
    num = den = 0.0
    for x, got in zip(inputs, outs):
        ref = fwd_d(x)["fc8"]
        if not torch.isfinite(got).all():
            raise SystemExit("deploy: the logits are not finite")
        num += (got - ref).pow(2).sum().item()
        den += ref.pow(2).sum().item()
    rel_l2 = (num / den) ** 0.5
    graph_ms = _graph_ms(fwd, inputs, N_INPUTS)
    ok = rel_l2 <= LOGITS_REL_L2
    print(f"deploy trained alexnet fc8 logits vs the same weights dense f32:"
          f" rel L2 {rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}) "
          f"{'ok' if ok else 'FAIL'}; forward as a CUDA graph "
          f"{graph_ms:.3f} ms, phase 4's random-weight AlexNet row "
          f"{alexnet_graph_ms:.3f} ms {tag}")
    if not ok:
        raise SystemExit("the trained sparse alexnet disagrees with dense "
                         "f32")
    del fwd, fwd_d, aligned, fparams, trained, outs, inputs
    torch.cuda.empty_cache()

    # 7d. the command line: train, then test on its snapshot
    os.makedirs("build", exist_ok=True)
    stem = os.path.join("build", "cli_alexnet")
    common = ["--model", "alexnet", "--batch", str(TRAIN_BATCH),
              "--num-classes", str(TRAIN_CLASSES)]
    for m in mods.values():
        m.reset_counts()
    t0 = time.perf_counter()
    rc, out = _run_entry(cli.main, ["train", *common, "--iterations",
                                    str(CLI_TRAIN_ITERS), "--display", "1",
                                    "--snapshot-prefix", stem],
                         f"{stem}_train.log")
    its = [ln.rsplit("loss = ", 1)[1] for ln in out.splitlines()
           if ln.startswith("Iteration ")]
    snap = f"{stem}_iter_{CLI_TRAIN_ITERS}.npz"
    print(f"cli train alexnet b{TRAIN_BATCH}: losses {' '.join(its)}; "
          f"{out.strip().splitlines()[-1]}; exit {rc}, "
          f"{time.perf_counter() - t0:.1f} s {tag}")
    if rc != 0 or len(its) != CLI_TRAIN_ITERS or not os.path.exists(snap) \
            or not all(np.isfinite(float(v)) for v in its):
        raise SystemExit(f"cli train exited {rc}")
    t0 = time.perf_counter()
    rc, out = _run_entry(cli.main, [
        "test", *common, "--weights", snap, "--conv_mode", "3", "--sparsity",
        str(SPARSITY), "--iterations", str(CLI_ITERS)], f"{stem}_test.log")
    its = [ln.split("forward ")[1] for ln in out.splitlines()
           if ln.startswith("iteration ")]
    avg = [ln for ln in out.splitlines() if ln.startswith("average")]
    print(f"cli test alexnet b{TRAIN_BATCH} on the cli snapshot, --conv_mode"
          f" 3 --sparsity {SPARSITY}: forward per iteration "
          f"{', '.join(its)}; {avg[0] if avg else '?'}; exit {rc}, "
          f"{time.perf_counter() - t0:.1f} s {tag}")
    if rc != 0 or len(its) != CLI_ITERS:
        raise SystemExit(f"cli test on the trained snapshot exited {rc}")
    launches = {k: m.launches for k, m in mods.items()}
    print(f"cli train + test launches: {launches} (expected none: training "
          f"runs dense, the command line's test the XBSP arms) {tag}")
    if any(launches.values()):
        raise SystemExit("cli train or test launched a hand kernel")
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s wall {tag}")


class _Events:
    """Milliseconds between two CUDA events around each timed region."""

    def __init__(self):
        import torch

        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self.start.record()
        return self

    def __exit__(self, *exc):
        import torch

        self.end.record()
        torch.cuda.synchronize()
        self.ms = self.start.elapsed_time(self.end)


def _cpu_name() -> str:
    """The host CPU as /proc/cpuinfo (or lscpu) names it, with its machine
    type and widest vector extension."""
    import platform

    name, flags = "", set()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if key.strip() == "model name" and not name:
                    name = value.strip()
                elif key.strip() == "flags" and not flags:
                    flags = set(value.split())
    except OSError:
        pass
    if not name or name == "unknown":
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((ln.split(":", 1)[1].strip() for ln in
                         out.splitlines() if ln.startswith("Model name")),
                        name or "unnamed")
        except (OSError, subprocess.SubprocessError):
            name = name or "unnamed"
    isa = next((f for f in ("avx512f", "avx2") if f in flags), "")
    return f"{name} ({platform.machine()}{', ' + isa if isa else ''})"


def _rel_l2(got, ref) -> float:
    num = (got.double() - ref.double()).pow(2).sum().item()
    den = ref.double().pow(2).sum().item()
    return (num / max(den, 1e-300)) ** 0.5


def _fmt_ms(values) -> str:
    return " ".join(f"{v:.1f}" for v in values)


def _phase_data(mods, tag, results, dev):
    """Phase 8: the data slice on the card; see the module docstring. Adds
    8b's launches to ``results``. Every file goes to a temporary
    directory that the phase removes."""
    import tempfile

    import torch

    from caffe_escoin_tpu_torch.data import datasets, lmdb_io, native
    from caffe_escoin_tpu_torch.data.pipeline import PrefetchLoader
    from caffe_escoin_tpu_torch.data.transformer import (DataTransformer,
                                                         TransformParams)
    from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                       ExecutionPolicy)
    from caffe_escoin_tpu_torch.engine.solver import Solver
    from caffe_escoin_tpu_torch.engine.solvers import SolverConfig
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import (LayerSpec, Net, fuse_inference,
                                           params_to)
    from caffe_escoin_tpu_torch.ops import conv as conv_ops
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
    from caffe_escoin_tpu_torch.tools import cli
    from caffe_escoin_tpu_torch.tools.prototxt import (net_from_prototxt,
                                                       net_to_prototxt)
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight
    from caffe_escoin_tpu_torch.utils import trace

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        # 8a. the databases, from seed 0
        t0 = time.perf_counter()
        rng = np.random.default_rng(SEED)
        n, hw = DATA_IMAGES, DATA_HW
        imgs = rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)
        labels = rng.integers(0, DATA_CLASSES, n)
        db = os.path.join(tmp, "train_lmdb")
        os.makedirs(db)
        lmdb_io.write_lmdb(db, [(b"%08d" % i, lmdb_io.datum_encode(
            imgs[i], int(labels[i]))) for i in range(n)])
        t_lmdb = time.perf_counter() - t0
        cerec = os.path.join(tmp, "train.cerec")
        t0 = time.perf_counter()
        datasets.write_cerec(cerec, imgs, labels)
        t_cerec = time.perf_counter() - t0
        mean_npy = os.path.join(tmp, "mean.npy")
        t0 = time.perf_counter()
        rc, _ = _run_entry(cli.main, ["compute_image_mean", cerec, mean_npy],
                           os.path.join(tmp, "mean.log"))
        t_mean = time.perf_counter() - t0
        mean = np.load(mean_npy)
        want = imgs.astype(np.float64).mean(axis=0)
        if rc != 0 or mean.shape != (hw, hw, 3) or \
                np.abs(mean - want).max() > 1e-3:
            raise SystemExit(f"compute_image_mean: exit {rc}, mean "
                             f"{mean.shape} off by "
                             f"{np.abs(mean - want).max():.3e}")
        mdb_mb = os.path.getsize(os.path.join(db, "data.mdb")) / 1e6
        print(f"data write: {n} random uint8 images {hw}x{hw}x3 from seed "
              f"{SEED}: LMDB {mdb_mb:.1f} MB (write_lmdb + datum_encode) in {t_lmdb:.2f} s, .cerec "
              f"{os.path.getsize(cerec) / 1e6:.1f} MB (f32 records) in "
              f"{t_cerec:.2f} s, cli compute_image_mean in {t_mean:.2f} s "
              f"(mean {mean.mean():.3f}, max |diff| to numpy "
              f"{np.abs(mean - want).max():.2e}) {tag}")
        try:
            from PIL import Image
        except ImportError as e:
            print(f"data convert_imageset: skipped, PIL does not import on "
                  f"this machine ({e}) {tag}")
        else:
            pngs = os.path.join(tmp, "png")
            os.makedirs(pngs)
            with open(os.path.join(tmp, "list.txt"), "w") as fh:
                for i in range(DATA_PNGS):
                    Image.fromarray(imgs[i]).save(
                        os.path.join(pngs, f"im{i}.png"))
                    fh.write(f"im{i}.png {labels[i]}\n")
            out_db = os.path.join(tmp, "png_lmdb")
            os.makedirs(out_db)
            t0 = time.perf_counter()
            rc, _ = _run_entry(cli.main, [
                "convert_imageset", os.path.join(tmp, "list.txt"), out_db,
                "--root-folder", pngs, "--backend", "lmdb"],
                os.path.join(tmp, "convert.log"))
            t_conv = time.perf_counter() - t0
            back = list(lmdb_io.LmdbReader(out_db).items())
            ok = rc == 0 and len(back) == DATA_PNGS
            for i, (_, raw) in enumerate(back):
                arr, lb = lmdb_io.datum_decode(raw)
                ok = ok and lb == labels[i] and np.array_equal(
                    arr, imgs[i].astype(arr.dtype))
            print(f"data convert_imageset --backend lmdb: {DATA_PNGS} PNGs "
                  f"in {t_conv:.2f} s, pixels and labels read back "
                  f"{'equal' if ok else 'DIFFERENT'} {tag}")
            if not ok:
                raise SystemExit("convert_imageset: the LMDB does not hold "
                                 "the PNGs")

        # 8b. ResNet-50 b32 from a TEST-phase Data layer over the LMDB
        t0 = time.perf_counter()
        build, _ = ZOO["resnet50"]
        head, body = net_to_prototxt(build(), None, name="resnet50").split(
            "\n", 1)
        text = "\n".join([head, DATA_LAYER.format(
            mean=mean_npy, db=db, batch=DATA_BATCH), body])
        specs, shapes, _ = net_from_prototxt(text, phase="test",
                                             synthesize_data=False)
        if shapes or specs[0].type != "Data":
            raise SystemExit(f"prototxt: inputs {shapes}, first layer "
                             f"{specs[0].type}")
        pol_s = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                                block_shape=BLOCK,
                                compute_dtype=torch.bfloat16,
                                cast_back=False, use_xla_sparse=False)
        net = Net(specs, policy=pol_s, phase="test")  # device None: the card
        params = net.init(torch.Generator().manual_seed(SEED), {})
        fnet, fparams = fuse_inference(net, _prune(net, params),
                                       state=net.state0)
        aligned = fnet.weight_align(fparams)
        routes = fnet.routes(aligned, {})
        expect = fnet.launches(aligned, {})
        if _routed(expect) != DATA_RESNET_LAUNCHES:
            raise SystemExit(f"data resnet50: routes name {_routed(expect)}, "
                             f"expected {DATA_RESNET_LAUNCHES}")
        fwd = fnet.inference_fn(params_to(aligned, dev, torch.bfloat16),
                                return_blobs=True)
        dense = Net([s for s in fnet.specs if s.type != "Data"],
                    policy=ExecutionPolicy()).inference_fn(
            params_to(fparams, dev), return_blobs=True)
        print(f"data resnet50 b{DATA_BATCH}: prototxt Data layer (TEST, "
              f"LMDB, crop 224, mean_file) + the ZOO's ResNet-50, "
              f"{len(fnet.layers)} layers fused, {SPARSITY:.0%} in "
              f"{BLOCK[0]}x{BLOCK[1]} blocks, SCONV_PAR bf16 kernel routes; "
              f"routes {dict(collections.Counter(routes.values()))}, set-up "
              f"{time.perf_counter() - t0:.1f} s {tag}")
        try:
            for m in mods.values():
                m.reset_counts()
            outs = []
            for _ in range(N_INPUTS):
                blobs = fwd({})
                outs.append((blobs["data"].clone(),
                             blobs["fc1000"].float().clone()))
            sync()
            launches = {k: m.launches for k, m in mods.items()}
            print(f"data resnet50 launches over {N_INPUTS} forwards: "
                  f"{launches} (expected {N_INPUTS} x {dict(expect)}) {tag}")
            for name, cnt in launches.items():
                if cnt != N_INPUTS * expect.get(name, 0):
                    raise SystemExit(f"data resnet50 launched {name} {cnt} "
                                     f"times")
                results[name]["launches"] += cnt
            num = den = 0.0
            for x, logits in outs:
                if x.device != dev or x.shape != (DATA_BATCH, 224, 224, 3) \
                        or logits.shape != (DATA_BATCH, 1000) \
                        or not torch.isfinite(logits).all():
                    raise SystemExit(f"data resnet50: data {tuple(x.shape)} "
                                     f"on {x.device}, logits not finite or "
                                     f"{tuple(logits.shape)}")
                ref = dense({"data": x})["fc1000"]
                num += (logits - ref).pow(2).sum().item()
                den += ref.pow(2).sum().item()
            rel = (num / den) ** 0.5
            ok = rel <= LOGITS_REL_L2
            print(f"data resnet50 fc1000 logits vs dense f32 on the same "
                  f"transformed batches: rel L2 {rel:.3e} (limit "
                  f"{LOGITS_REL_L2:.0e}) {'ok' if ok else 'FAIL'} {tag}")
            if not ok:
                raise SystemExit("data resnet50 disagrees with dense f32")
            times = []
            for _ in range(DATA_TIMED):
                sync()
                t0 = time.perf_counter()
                fwd({})
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            waits = [w * 1e3 for w in fnet.layers[0].loader.waits]
            print(f"data resnet50 eager forward with the Data layer's pop, "
                  f"host clock around forward + synchronize, {DATA_TIMED} "
                  f"forwards: mean {np.mean(times):.2f} ms (min "
                  f"{min(times):.2f}, max {max(times):.2f}); the loader's "
                  f"waits over all {len(waits)} pops, ms: {_fmt_ms(waits)} "
                  f"{tag}")
        finally:
            fnet.close()
        del fwd, dense, aligned, fparams, outs
        if cuda:
            torch.cuda.empty_cache()

        # 8c. AlexNet b32 training from three sources
        build, in_shapes = ZOO["alexnet"]
        specs = _xavier(build(num_classes=DATA_CLASSES, include_loss=True))
        shapes = {"data": (DATA_BATCH,) + tuple(in_shapes["data"][1:]),
                  "label": (DATA_BATCH,)}
        crop = shapes["data"][1]
        cfg = SolverConfig(base_lr=0.01, momentum=0.9, weight_decay=5e-4)
        train_tp = TransformParams(crop_size=crop, mirror=True,
                                   scale=DATA_TRAIN_SCALE, mean_image=mean,
                                   phase="train")

        def train(source, net, init_shapes, next_batch, loader_of):
            solver = Solver(net, cfg, seed=SEED, device=dev, display=1)
            solver.init(init_shapes)
            rows, losses = [], []
            try:
                for i in range(DATA_TRAIN_STEPS):
                    logs = []
                    sync()
                    t0 = time.perf_counter()
                    batch = next_batch()
                    if cuda:
                        with _Events() as ev:
                            solver.step(iter([batch]), 1, log=logs.append)
                        ms = ev.ms
                    else:
                        solver.step(iter([batch]), 1, log=logs.append)
                        ms = float("nan")
                    sync()
                    wall = (time.perf_counter() - t0) * 1e3
                    losses.append(float(logs[-1].rsplit("loss = ", 1)[1]))
                    rows.append((ms, wall))
                waits = [w * 1e3 for w in loader_of().waits]
            finally:
                net.close()
            steady = rows[1:]
            ev_ms = [a for a, _ in steady]
            walls = [b for _, b in steady]
            ips = DATA_BATCH * len(walls) / (sum(walls) / 1e3)
            print(f"data train alexnet b{DATA_BATCH} from {source}: "
                  f"{np.mean(ev_ms):.2f} ms per step between CUDA events "
                  f"(min {min(ev_ms):.2f}, max {max(ev_ms):.2f}), "
                  f"{np.mean(walls):.2f} ms wall with the batch, "
                  f"{ips:.1f} images/s over steps 1-{DATA_TRAIN_STEPS - 1}; "
                  f"loader waits ms {_fmt_ms(waits)}; losses "
                  f"{' '.join(f'{v:.4f}' for v in losses)} {tag}")
            if not all(np.isfinite(losses)):
                raise SystemExit(f"data train from {source}: a loss is not "
                                 f"finite")
            del solver
            if cuda:
                torch.cuda.empty_cache()

        loader = PrefetchLoader(
            datasets.synthetic_source(shapes["data"],
                                      num_classes=DATA_CLASSES, seed=SEED),
            device=dev, timeout=DATA_WAIT_TIMEOUT)
        try:
            train("synthetic_source on PrefetchLoader's thread",
                  Net(specs, phase="train"), shapes, lambda: next(loader),
                  lambda: loader)
        finally:
            loader.close()
        lib = native.load_library()
        if lib is None:
            raise SystemExit(f"the native library did not build: "
                             f"{native.build_error}")
        built = trace.snapshot()["spans"].get("setup:native_build")
        print(f"data native library: {native.library_path(native._cxx()).name}"
              f" under build/native ("
              + (f"g++ {built['total_s']:.1f} s" if built
                 else "built before") + f") {tag}")
        with native.NativeCerecLoader(cerec, DATA_BATCH, (hw, hw, 3),
                                      shuffle=True, seed=SEED, workers=2,
                                      timeout=DATA_WAIT_TIMEOUT) as nl:
            loader = PrefetchLoader(
                lambda: next(nl), transform=DataTransformer(train_tp,
                                                            seed=SEED),
                device=dev, timeout=DATA_WAIT_TIMEOUT)
            try:
                train("NativeCerecLoader (2 C++ workers, shuffled) + the "
                      "TRAIN transformer (crop, mirror, mean, scale) on "
                      "PrefetchLoader's thread", Net(specs, phase="train"),
                      shapes, lambda: next(loader), lambda: loader)
            finally:
                loader.close()
        data_spec = LayerSpec("data", "Data", (), ("data", "label"),
                              params=dict(source=db, batch_size=DATA_BATCH,
                                          backend="lmdb", transform_param=dict(
                                              crop_size=crop, mirror=True,
                                              scale=DATA_TRAIN_SCALE,
                                              mean_file=mean_npy)))
        dnet = Net([data_spec] + specs, phase="train")
        train("the Data layer over the LMDB (one thread: decode and "
              "transform)", dnet, {}, lambda: {},
              lambda: dnet.layers[0].loader)

    # 8d. the native host route
    label, batch, h, cin, cout, k, pad, block = NATIVE_SHAPE
    rng = np.random.default_rng(SEED + 3)
    w = prune_conv_weight(rng.standard_normal((k, k, cin, cout)).astype(
        np.float32) * (2.0 / (k * k * cin)) ** 0.5, SPARSITY, block)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    pol = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=block,
                          native_cpu=True)
    al = weight_align(w, b, policy=pol)
    x = torch.from_numpy(rng.standard_normal((batch, h, h, cin)).astype(
        np.float32))
    calls = [0]
    real = native.native_bsc_sconv

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    native.native_bsc_sconv = counting
    try:
        out = conv_ops.conv2d(x, al, padding=(pad, pad), relu=True,
                              policy=pol)
        t0 = time.perf_counter()
        for _ in range(NATIVE_REPS):
            conv_ops.conv2d(x, al, padding=(pad, pad), relu=True, policy=pol)
        host_ms = (time.perf_counter() - t0) / NATIVE_REPS * 1e3
    finally:
        native.native_bsc_sconv = real
    t0 = time.perf_counter()
    for _ in range(NATIVE_REPS):
        ref = conv_ops.conv2d_dense(x, torch.from_numpy(w), b,
                                    padding=(pad, pad), relu=True)
    plain_ms = (time.perf_counter() - t0) / NATIVE_REPS * 1e3
    err = (out - ref).abs().max().item()
    bound = 1e-4 * ref.abs().max().item()
    ok = calls[0] == NATIVE_REPS + 1 and err <= bound
    print(f"data native_cpu {label}, {SPARSITY:.0%} in {block[0]}x{block[1]} "
          f"blocks ({al.bsc.nnz_blocks} live), CPU tensors through "
          f"ops.conv.conv2d (SCONV_PAR, native_cpu): csrc/sconv.cc ran "
          f"{calls[0]} times; max abs err {err:.3e} vs the plain f32 conv "
          f"(bound {bound:.3e}) {'ok' if ok else 'FAIL'}; host "
          f"{host_ms:.1f} ms per call ({min(8, os.cpu_count() or 1)} "
          f"threads), the plain dense conv (F.conv2d, CPU) {plain_ms:.1f} "
          f"ms; CPU {_cpu_name()}, {os.cpu_count()} cores {tag}")
    if not ok:
        raise SystemExit("the native host route failed")

    # 8e. the other new layer types and stochastic pooling, card vs CPU
    import types

    from caffe_escoin_tpu_torch.nn import Layer

    user = types.ModuleType("chip_smoke_user_layers")

    class DoubleLayer(Layer):
        def forward(self, params, inputs, state=None):
            return [inputs[0] * 2.0]

    user.DoubleLayer = DoubleLayer
    sys.modules[user.__name__] = user
    rng = np.random.default_rng(SEED + 4)
    worst = []
    for kind, p, bottoms, n_tops in CATALOG_CASES:
        xs = {}
        for i, bt in enumerate(bottoms):
            if bt == "cont":
                v = np.ones((6, 4), np.float32)
                v[0] = 0
            elif bt == "idx":
                v = rng.integers(0, 10, (5, 3)).astype(np.int64)
            elif bt == "reindex":
                v = rng.integers(0, 6, 5).astype(np.int64)
            elif bt == "sel":
                v = np.array([1, 0, 1, 1, 0, 1], np.float32)
            elif bt == "pos":
                v = rng.uniform(0.1, 2.0, (2, 9, 9, 4)).astype(np.float32)
            else:
                v = rng.standard_normal(bt).astype(np.float32)
            xs[f"in{i}"] = v
        tops = tuple(f"t{i}" for i in range(n_tops))
        if kind == "Python":
            p = dict(module=user.__name__, layer="DoubleLayer")
        lnet = Net([LayerSpec("l", kind, tuple(xs), tops, params=p)])
        lp = lnet.init(torch.Generator().manual_seed(SEED),
                       {k: v.shape for k, v in xs.items()})
        cpu = lnet(lp, {k: torch.from_numpy(v) for k, v in xs.items()})
        got = lnet(params_to(lp, dev), {k: torch.from_numpy(v).to(dev)
                                        for k, v in xs.items()})
        for t in tops:
            if got[t].device != dev or got[t].shape != cpu[t].shape:
                raise SystemExit(f"{kind} {t}: {tuple(got[t].shape)} on "
                                 f"{got[t].device}")
            worst.append((_rel_l2(got[t].cpu(), cpu[t]), f"{kind}.{t}"))
    bad = [(r, n) for r, n in worst if not r <= CATALOG_REL_L2]
    x = torch.rand((4, 8, 8, 16), device=dev) + 0.1
    from caffe_escoin_tpu_torch.ops.pool import pool2d

    gen = torch.Generator(device=dev).manual_seed(SEED)
    s = pool2d(x, (2, 2), stride=(2, 2), mode="stochastic", train=True,
               generator=gen)
    win = x.reshape(4, 4, 2, 4, 2, 16).permute(0, 1, 3, 5, 2, 4).reshape(
        4, 4, 4, 16, 4)
    member = bool((win == s[..., None]).any(-1).all())
    picked_max = (s == win.amax(-1)).float().mean().item()
    print(f"data layers on the card vs the CPU ({len(CATALOG_CASES)} "
          f"layers, f32, TF32 off): worst rel L2 {max(worst)[0]:.2e} "
          f"({max(worst)[1]}; limit {CATALOG_REL_L2:.0e}) "
          f"{'ok' if not bad else 'FAIL ' + str(bad)}; stochastic pooling "
          f"TRAIN on a CUDA generator: every sample a member of its window "
          f"{member}, the window max picked {picked_max:.3f} of the time "
          f"(uniform 0.25) {tag}")
    if bad or not member:
        raise SystemExit("the catalog layers differ between the card and "
                         "the CPU")
    print(f"data phase: {time.perf_counter() - t_phase:.1f} s wall {tag}")


def _phase_parallel(mods, tag, results, dev):
    """Phase 9: parallel/, tools/scaling.py, the dry run, sparse/permute.py
    and tools/vision.py at world size 1 over NCCL, in a group made from an
    in-process store and destroyed at the end; see the module docstring.
    Adds the launches of every checked run to ``results``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from caffe_escoin_tpu_torch.engine import solvers
    from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                       ExecutionPolicy,
                                                       SparseFormat)
    from caffe_escoin_tpu_torch.engine.solver import Solver
    from caffe_escoin_tpu_torch.kernels import sconv_gc
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
    from caffe_escoin_tpu_torch.ops import conv as conv_ops
    from caffe_escoin_tpu_torch.parallel import dp, halo, tp
    from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib
    from caffe_escoin_tpu_torch.parallel.dryrun import dryrun_multichip
    from caffe_escoin_tpu_torch.sparse import permute
    from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
    from caffe_escoin_tpu_torch.tools import scaling, vision
    from caffe_escoin_tpu_torch.utils.benchmark import device_time
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    platform = "cuda" if cuda else "cpu"
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def launched(fn):
        """(fn(), the launches it made per kernel): the counts are set to 0
        just before and read just after."""
        for m in mods.values():
            m.reset_counts()
        out = fn()
        sync()
        return out, {k: m.launches for k, m in mods.items()}

    def count(label, got, expect):
        want = {k: expect.get(k, 0) for k in mods}
        print(f"parallel {label} launches: {got} (expected {want}) {tag}")
        if got != want:
            raise SystemExit(f"parallel {label} launched {got}, expected "
                             f"{want}")
        for k, n in got.items():
            results[k]["launches"] += n

    def kernels_of(routes):
        """The launches of convs on these routes (a halo chain: no net)."""
        out = collections.Counter()
        for r in routes:
            out.update(conv_ops.route_launches(r))
        return out

    def max_err(got, ref):
        return (got.float() - ref.float()).abs().max().item()

    def rel_l2(got, ref):
        got, ref = got.double(), ref.double()
        return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()

    def conv_weight(k, cin, cout, block):
        wt = prune_conv_weight(
            rng.standard_normal((k, k, cin, cout)).astype(np.float32)
            * np.float32((2.0 / (k * k * cin)) ** 0.5), SPARSITY, block)
        b = rng.standard_normal(cout).astype(np.float32) * np.float32(0.1)
        return weight_align(wt, b, policy=ExecutionPolicy(
            block_shape=block)).to(dev, torch.bfloat16)

    pol_k = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                            compute_dtype=torch.bfloat16, cast_back=False,
                            use_xla_sparse=False)
    made = not dist.is_initialized()
    mesh_lib.multihost_init(platform=platform)
    try:
        mesh = mesh_lib.make_mesh()
        print(f"parallel: world {dist.get_world_size()}, backend "
              f"{dist.get_backend()}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, group from an "
              f"in-process store {tag}")

        # 9a. the halo path on sconv_gc, then the chain and the tower
        label, b, hw, cin, cout = PAR_HALO
        al = conv_weight(3, cin, cout, BLOCK)
        x = torch.randn((b, hw, hw, cin), generator=gen, device=dev
                        ).bfloat16()

        def halo_fwd(y):
            return halo.spatial_sconv2d(y, al, mesh=mesh, padding=(1, 1),
                                        policy=pol_k, relu=True,
                                        engine="pallas")

        def gc_fwd(y):
            return sconv_gc.sconv(y, al, padding=(1, 1), relu=True)

        out, got = launched(lambda: halo_fwd(x))
        count(f"halo engine=pallas {label}", got, {"sconv_gc": 1})
        err = max_err(out, gc_fwd(x))
        ms = {k: device_time(f, x, iters=TIMED_ITERS) * 1e3
              for k, f in (("halo", halo_fwd), ("sconv_gc", gc_fwd),
                           ("halo again", halo_fwd))}
        print(f"parallel halo engine=pallas {label} (b{b} {hw}x{hw}, "
              f"{cin}->{cout}, {SPARSITY:.0%} in {BLOCK[0]}x{BLOCK[1]} "
              f"blocks, bf16): max|halo - sconv_gc.sconv(x, padding=(1, "
              f"1))| {err} (must be 0); device ms, CUDA-graph replays: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + f" {tag}")
        if err != 0:
            raise SystemExit("the halo path differs from sconv_gc")
        b, hw, chans = PAR_STACK
        als = [conv_weight(3, ci, co, BLOCK) for ci, co in chans]
        x = torch.randn((b, hw, hw, chans[0][0]), generator=gen, device=dev
                        ).bfloat16()

        def in_sequence(y):
            for a in als:
                y = conv_ops.conv2d(y, a, padding=(1, 1), relu=True,
                                    policy=pol_k)
            return y

        ref = in_sequence(x)
        for kind, fn in (("chain", halo.spatial_sconv_chain),
                         ("tower", halo.spatial_sconv_tower)):
            # the rows each conv sees: the chain's one halo per layer, the
            # tower's summed halo shrinking by one per layer
            rows = ([hw + 2] * 3 if kind == "chain"
                    else [hw + 6, hw + 4, hw + 2])
            routes = [conv_ops.conv_route(
                torch.empty((b, r, hw, a.cin), dtype=torch.bfloat16,
                            device="meta"), a, padding=(0, 1), policy=pol_k)
                for r, a in zip(rows, als)]
            out, got = launched(lambda: fn(x, als, mesh=mesh, policy=pol_k,
                                           relu=True))
            count(f"halo {kind} vgg16 conv3_1-3_3", got, kernels_of(routes))
            err, peak = max_err(out, ref), ref.float().abs().max().item()
            ok = out.shape == ref.shape and err <= PARITY_REL * peak \
                + PARITY_ABS
            print(f"parallel halo {kind} vgg16 conv3_1-3_3 (b{b} {hw}x{hw}, "
                  f"{chans}): routes {routes}; max|{kind} - the three convs "
                  f"in sequence| {err:.3e} (max|ref| {peak:.3e}, limit "
                  f"{PARITY_REL:g} x max|ref| + {PARITY_ABS:g}) "
                  f"{'ok' if ok else 'FAIL'} {tag}")
            if not ok:
                raise SystemExit(f"the halo {kind} differs from the convs in "
                                 f"sequence")
        del x, ref, out, als

        # 9b. tensor parallelism on bsc_spmm
        label, b, hw, cin, cout, block = PAR_TP
        pol_tp = dataclasses.replace(pol_k, block_shape=block)
        al = conv_weight(3, cin, cout, block)
        x = torch.randn((b, hw, hw, cin), generator=gen, device=dev
                        ).bfloat16()

        def tp_fwd(y):
            return tp.tp_conv_lowered(y, al, mesh=mesh, padding=(1, 1),
                                      relu=True, policy=pol_tp)

        def lowered_fwd(y):
            return conv_ops.conv2d_lowered_sparse(
                y, al, stride=(1, 1), padding=(1, 1), dilation=(1, 1),
                relu=True, policy=pol_tp)

        out, got = launched(lambda: tp_fwd(x))
        count(f"tp_conv_lowered {label}", got, {"bsc_spmm": 1})
        err = max_err(out, lowered_fwd(x))
        del out
        ms = {k: device_time(f, x, iters=TIMED_ITERS) * 1e3
              for k, f in (("tp", tp_fwd), ("lowered route", lowered_fwd),
                           ("tp again", tp_fwd))}
        print(f"parallel tp_conv_lowered {label} (b{b} {hw}x{hw}, "
              f"{cin}->{cout}, {SPARSITY:.0%} in {block[0]}x{block[1]} "
              f"blocks, bf16): max|tp - the lowered route| {err} (must be "
              f"0); device ms, CUDA-graph replays: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + f" {tag}")
        if err != 0:
            raise SystemExit("tp_conv_lowered differs from the lowered route")
        del x
        if cuda:
            torch.cuda.empty_cache()

        # 9c. data parallelism: one AlexNet step against the Solver's
        build, in_shapes = ZOO["alexnet"]
        specs = _xavier(build(num_classes=TRAIN_CLASSES, include_loss=True))
        shapes = {"data": (PAR_DP_BATCH,) + tuple(in_shapes["data"][1:]),
                  "label": (PAR_DP_BATCH,)}
        cfg = solvers.SolverConfig(base_lr=0.01, momentum=0.9,
                                   weight_decay=5e-4)
        solver = Solver(Net(specs, phase="train"), cfg, seed=SEED,
                        device=dev, display=0)
        solver.init(shapes)
        p0 = solvers.tree_map(lambda t: t.detach().clone(), solver.params)
        p_dp = solvers.tree_map(lambda t: t.clone(), p0)
        batch = {"data": torch.randn(shapes["data"], generator=gen,
                                     device=dev),
                 "label": torch.randint(0, TRAIN_CLASSES, shapes["label"],
                                        generator=gen, device=dev)}
        step = dp.make_dp_train_step(
            Net(specs, phase="train", device=dev), cfg, mesh,
            lr_mults=solver.lr_mults, decay_mults=solver.decay_mults)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            _, _, _, loss = step(p_dp, solvers.init_state(cfg, p_dp), {},
                                 dp.shard_batch(mesh, batch), cfg.base_lr, 1,
                                 torch.Generator(device=dev).manual_seed(SEED))
            solver.step(iter([batch]), 1, log=lambda m: None)
        worst, where = 0.0, ""
        for name, blobs in p0.items():
            for k, w0 in blobs.items():
                rel = rel_l2(p_dp[name][k] - w0, solver.params[name][k] - w0)
                if rel >= worst:
                    worst, where = rel, f"{name}.{k}"
        ok = worst <= DP_UPDATE_REL
        print(f"parallel dp step alexnet b{PAR_DP_BATCH} (phase 7a's "
              f"config, world 1) vs one Solver step from the same params: "
              f"loss {float(loss):.6f} vs {solver._losses[-1]:.6f}; worst "
              f"update rel L2 {worst:.3e} at {where} (limit "
              f"{DP_UPDATE_REL:g}) {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("the DP step differs from the Solver step")
        del solver, p0, p_dp, batch, step
        if cuda:
            torch.cuda.empty_cache()

        build, in_shapes = ZOO["resnet50"]
        shapes = {"data": (PAR_DP_BATCH,) + tuple(in_shapes["data"][1:])}
        net = Net(build(), policy=pol_k)
        init = net.init(torch.Generator().manual_seed(SEED), shapes)
        fnet, fparams = fuse_inference(net, _prune(net, init),
                                       state=net.state0)
        aligned = fnet.weight_align(fparams)
        routes = fnet.routes(aligned, shapes)
        x = torch.randn(shapes["data"], generator=gen, device=dev) * 0.1
        fwd = dp.make_dp_eval_step(fnet, mesh)
        weights = params_to(aligned, dev, torch.bfloat16)
        out, got = launched(lambda: fwd(weights, dp.shard_batch(
            mesh, {"data": x})))
        count(f"dp eval resnet50 b{PAR_DP_BATCH}", got,
              fnet.launches(aligned, shapes))
        with torch.inference_mode():
            ref = Net(fnet.specs, policy=ExecutionPolicy()).apply(
                params_to(fparams, dev), {"data": x})["prob"]
        rel = rel_l2(out["prob"], ref)
        ok = rel <= LOGITS_REL_L2
        print(f"parallel dp eval resnet50 b{PAR_DP_BATCH} kernel routes: "
              f"prob vs dense f32 rel L2 {rel:.3e} (limit "
              f"{LOGITS_REL_L2:g}) {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("the DP forward disagrees with dense f32")
        del out, weights, aligned
        t0 = time.perf_counter()
        rows = [scaling.measure("resnet50", 1, PAR_DP_BATCH, SPARSITY,
                                TIMED_ITERS, platform=platform,
                                policy=ExecutionPolicy(
                                    conv_mode=ConvMode.SCONV_PAR,
                                    block_shape=BLOCK,
                                    use_xla_sparse=False)),
                scaling.measure_halo(1, SPARSITY, TIMED_ITERS,
                                     platform=platform),
                scaling.measure_tp(1, SPARSITY, TIMED_ITERS,
                                   platform=platform)]
        print(f"parallel scaling.measure resnet50 b{PAR_DP_BATCH} world 1, "
              f"the port's kernel routes, f32 activations (the JAX harness "
              f"runs the XBSP arms): "
              f"{rows[0]['samples_per_s']} samples/s, "
              f"{rows[0]['gnnz_per_s']} Gnnz/s, {rows[0]['time_s'] * 1e3:.3f}"
              f" ms per forward; measure_halo {rows[1]['gnnz_per_s']} "
              f"Gnnz/s ({rows[1]['time_s'] * 1e3:.4f} ms); measure_tp "
              f"{rows[2]['gnnz_per_s']} Gnnz/s "
              f"({rows[2]['time_s'] * 1e3:.4f} ms); device_time medians of "
              f"CUDA-graph replays, {time.perf_counter() - t0:.1f} s wall "
              f"[{rows[0]['device']}]")
        if any(r["devices"] != 1 or not r["time_s"] > 0 for r in rows):
            raise SystemExit(f"scaling rows {rows}")
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun_multichip(1, platform=platform)
        line = buf.getvalue().strip()
        print(f"parallel {line}; {time.perf_counter() - t0:.1f} s wall "
              f"{tag}")
        if not line.startswith("dryrun_multichip(1): OK"):
            raise SystemExit(f"dry run: {line}")
        if cuda:
            torch.cuda.empty_cache()

        # 9d. the permutation on phase 4c's element-wise pruned weights
        t0 = time.perf_counter()
        enet, eparams = fuse_inference(net, _prune(net, init, block=None),
                                       state=net.state0)
        pairs = permute.find_permutable_pairs(enet)
        perm0, rep0 = permute.deploy_unstructured(
            enet, eparams, block_shape=BLOCK, min_density=0.0)
        t_perm = time.perf_counter() - t0
        before = sum(r["blocks_before"] for r in rep0["permuted"])
        after = sum(r["blocks_after"] for r in rep0["permuted"])
        print(f"parallel permute resnet50 {SPARSITY:.0%} element-wise "
              f"(phase 4c's weights), fused: {len(pairs)} permutable pairs, "
              f"{len(rep0['permuted'])} permuted; live {BLOCK[0]}x{BLOCK[1]}"
              f" blocks of the permuted producers {before} -> {after}; "
              f"{t_perm:.1f} s host {tag}")
        ell_net = Net(enet.specs, policy=ExecutionPolicy(
            conv_mode=ConvMode.LOWERED_SPARSE,
            sparse_format=SparseFormat.ELL, block_shape=BLOCK))
        with torch.inference_mode():
            logits = [ell_net.apply(params_to(ell_net.weight_align(p), dev),
                                    {"data": x}, return_blobs=True)["fc1000"]
                      for p in (eparams, perm0)]
        rel = rel_l2(logits[1], logits[0])
        ok = rel <= PERMUTE_LOSSLESS_REL
        print(f"parallel permute min_density 0: ELL route f32, permuted vs "
              f"unpermuted fc1000 rel L2 {rel:.3e} (limit "
              f"{PERMUTE_LOSSLESS_REL:g}) {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("the permutation changed the net's function")
        del logits, perm0
        dep, rep = permute.deploy_unstructured(
            enet, eparams, block_shape=BLOCK, min_density=PAR_MIN_DENSITY)
        knet = Net(enet.specs, policy=pol_k)
        kal = knet.weight_align(dep)
        routes = knet.routes(kal, shapes)
        live = sum(kal[n].bsc.nnz_blocks for n in routes
                   if getattr(kal[n], "bsc", None) is not None)
        slots = sum(kal[n].bsc.n_brows * kal[n].bsc.n_bcols for n in routes
                    if getattr(kal[n], "bsc", None) is not None)
        kfwd = knet.inference_fn(params_to(kal, dev, torch.bfloat16),
                                 return_blobs=True)
        out, got = launched(lambda: kfwd({"data": x}))
        count(f"permute min_density {PAR_MIN_DENSITY:g} resnet50 "
              f"b{PAR_DP_BATCH}", got, knet.launches(kal, shapes))
        with torch.inference_mode():
            ref = Net(enet.specs, policy=ExecutionPolicy()).apply(
                params_to(dep, dev), {"data": x},
                return_blobs=True)["fc1000"]
        rel = rel_l2(out["fc1000"], ref)
        ok = rel <= LOGITS_REL_L2
        zeroed = np.mean([r["extra_zeroed_frac"] for r in rep["densified"]])
        print(f"parallel permute min_density {PAR_MIN_DENSITY:g}: "
              f"{len(rep['densified'])} layers densified, mean extra zeroed "
              f"{zeroed:.4f}; live blocks {live} of {slots} after "
              f"densification; routes "
              f"{dict(collections.Counter(routes.values()))}; fc1000 vs "
              f"dense f32 on the deployed weights rel L2 {rel:.3e} (limit "
              f"{LOGITS_REL_L2:g}) {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("the deployed net disagrees with dense f32")
        del out, kfwd, kal, dep, eparams, init, fparams
        if cuda:
            torch.cuda.empty_cache()

        # 9e. the Classifier and the Detector on AlexNet, kernel routes
        build, in_shapes = ZOO["alexnet"]
        specs = [s for s in build() if s.type != "Softmax"]  # fc8 logits
        n_crops = 10 * PAR_VISION_IMAGES
        shapes = {"data": (n_crops,) + tuple(in_shapes["data"][1:])}
        net = Net(specs, policy=pol_k, device=dev)
        init = net.init(torch.Generator().manual_seed(SEED), shapes)
        vnet, vparams = fuse_inference(net, _prune(net, init, keep_norm=True),
                                       state=net.state0)
        vnet.device = dev
        valigned = vnet.weight_align(vparams)
        dense_net = Net(vnet.specs, device=dev)
        dense_net.blob_shapes = vnet.blob_shapes
        images = [rng.random((PAR_VISION_HW, PAR_VISION_HW, 3)).astype(
            np.float32) * np.float32(2.0) for _ in range(PAR_VISION_IMAGES)]
        kw = dict(output_name="fc8", image_dims=(PAR_VISION_HW,) * 2,
                  mean=[1.0, 1.0, 1.0])
        clf = vision.Classifier(vnet, valigned, **kw)
        preds, got = launched(lambda: clf.predict(images))
        count(f"vision Classifier alexnet {PAR_VISION_IMAGES} images x 10 "
              f"crops", got, vnet.launches(valigned, shapes))
        ref = vision.Classifier(dense_net, vparams, **kw).predict(images)
        rel = rel_l2(torch.from_numpy(preds), torch.from_numpy(ref))
        ok = preds.shape == (PAR_VISION_IMAGES, 1000) and rel <= \
            LOGITS_REL_L2
        print(f"parallel vision Classifier.predict alexnet: "
              f"{PAR_VISION_IMAGES} images {PAR_VISION_HW}x{PAR_VISION_HW} "
              f"-> {n_crops} crops 227x227 on the kernel routes, averaged "
              f"fc8 {preds.shape} vs dense f32 rel L2 {rel:.3e} (limit "
              f"{LOGITS_REL_L2:g}) {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("the Classifier disagrees with dense f32")
        windows = [(int(y), int(x), int(y) + 96, int(x) + 128) for y, x in
                   rng.integers(0, PAR_VISION_HW - 128, (PAR_WINDOWS, 2))]
        det = vision.Detector(vnet, valigned, output_name="fc8")
        dets, got = launched(lambda: det.detect_windows(
            [(images[0], windows)]))
        count(f"vision Detector alexnet {PAR_WINDOWS} windows", got,
              vnet.launches(valigned, {
                  "data": (PAR_WINDOWS,) + shapes["data"][1:]}))
        ref = vision.Detector(dense_net, vparams,
                              output_name="fc8").detect_windows(
            [(images[0], windows)])
        rel = rel_l2(torch.from_numpy(np.stack([d["prediction"]
                                                for d in dets])),
                     torch.from_numpy(np.stack([d["prediction"]
                                                for d in ref])))
        ok = (len(dets) == PAR_WINDOWS and rel <= LOGITS_REL_L2
              and [d["window"] for d in dets] == windows)
        print(f"parallel vision Detector.detect_windows alexnet: "
              f"{PAR_WINDOWS} windows with context padding, warped to "
              f"227x227 (PIL), fc8 vs dense f32 rel L2 {rel:.3e} (limit "
              f"{LOGITS_REL_L2:g}) {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("the Detector disagrees with dense f32")
    finally:
        if made:
            dist.destroy_process_group()
    wall = time.perf_counter() - t_phase
    print(f"parallel phase: {wall:.1f} s wall (budget {PAR_BUDGET_S} s) "
          f"{tag}")


@contextlib.contextmanager
def _solver_clock(dev):
    """While open, every ``Solver`` records its iterations: the loss of
    each, its time between CUDA events around ``Solver._step`` (forward,
    backward, update and masks; the host clock on the CPU), the wall of
    each ``Solver.step`` call (batches and mask recomputes included, ended
    by a synchronize) and the host seconds of each mask recompute
    (``Solver.mask_update_s``)."""
    import torch

    from caffe_escoin_tpu_torch.engine.solver import Solver

    cuda = dev.type == "cuda"
    clock = dict(losses=[], spans=[], wall=0.0, iters=0, masks=[])
    step, inner, remask = (Solver.step, Solver._step,
                           Solver._maybe_update_masks)

    def timed_inner(self, *a, **k):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = inner(self, *a, **k)
            end.record()
            clock["spans"].append((start, end))
        else:
            t0 = time.perf_counter()
            loss = inner(self, *a, **k)
            clock["spans"].append((time.perf_counter() - t0, None))
        clock["losses"].append(float(loss))
        return loss

    def timed_step(self, data_iter, iters, log=print):
        t0, it0 = time.perf_counter(), self.iter
        out = step(self, data_iter, iters, log=log)
        if cuda:
            torch.cuda.synchronize()
        clock["wall"] += time.perf_counter() - t0
        clock["iters"] += self.iter - it0
        return out

    def timed_remask(self, log=print):
        remask(self, log=log)
        if self.mask_update_s is not None:
            clock["masks"].append(self.mask_update_s)

    Solver.step, Solver._step = timed_step, timed_inner
    Solver._maybe_update_masks = timed_remask
    try:
        yield clock
    finally:
        Solver.step, Solver._step = step, inner
        Solver._maybe_update_masks = remask


def _clock_line(clock) -> str:
    """Steps, ms per step between CUDA events (median, mean), wall per step
    with and without the mask recomputes, and their host time."""
    ms = [s * 1e3 if e is None else s.elapsed_time(e)
          for s, e in clock["spans"]]
    n, masks = max(1, clock["iters"]), clock["masks"]
    return (f"{clock['iters']} steps: {statistics.median(ms):.2f} ms median "
            f"({statistics.mean(ms):.2f} mean) between events around "
            f"Solver._step, wall {clock['wall'] / n * 1e3:.2f} ms per step "
            f"({(clock['wall'] - sum(masks)) / n * 1e3:.2f} without the "
            f"{len(masks)} mask recomputes, {sum(masks):.2f} s of host "
            f"together)")


def _ex_rows(res, label, tag, dense_min=None):
    """Print an example's table and fail unless every row's achieved
    sparsity is within ``EX_SPARSITY_TOL`` of its target and its sparse
    score within ``EX_DELTA`` of its fine-tuned one (and the dense score
    at least ``dense_min``)."""
    from caffe_escoin_tpu_torch.examples import train_eval_sparse as tes

    for line in tes.markdown(res).splitlines():
        if line:
            print(f"examples {label} | {line}")
    bad = [r for r in res["rows"]
           if abs(r["achieved_sparsity"] - r["target_sparsity"])
           > EX_SPARSITY_TOL or abs(r["sparse_exec_delta"]) > EX_DELTA]
    ok = not bad and (dense_min is None or res["dense_acc"] >= dense_min)
    print(f"examples {label}: dense {res['dense_acc']:.4f}"
          + (f" (limit >= {dense_min})" if dense_min is not None else "")
          + f", {len(res['rows'])} rows, every achieved sparsity within "
          f"{EX_SPARSITY_TOL} of its target and every |sparse-exec - "
          f"fine-tuned| <= {EX_DELTA:.4f}: {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit(f"examples {label}: dense {res['dense_acc']}, rows "
                         f"out of bounds {bad}")


def _phase_examples(mods, tag, results, dev, full=False):
    """Phase 10: the example scripts of caffe_escoin_tpu_torch/examples/
    on the card; see the module docstring. ``full`` runs 10b at the JAX
    package's recipe length (``EX_ALEXNET_FULL``). Adds 10b's kernel-route
    launches to ``results``."""
    import dataclasses
    from argparse import Namespace

    import torch

    from caffe_escoin_tpu_torch.examples import net_surgery, siamese_digits
    from caffe_escoin_tpu_torch.examples import train_eval_sparse as tes
    from caffe_escoin_tpu_torch.nn import Net, params_to

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    platform = dev.type
    quiet = dict(log=lambda *_: None)

    def launches():
        if cuda:
            torch.cuda.synchronize()
        return {k: m.launches for k, m in mods.items()}

    def no_launches(label):
        got = launches()
        print(f"examples {label} launches: {got} (expected none: the XBSP "
              f"arms, dense layers and training) {tag}")
        if any(got.values()):
            raise SystemExit(f"examples {label} launched a hand kernel")

    # 10a. LeNet: docs/EXPERIMENTS.md's table
    for m in mods.values():
        m.reset_counts()
    t0 = time.perf_counter()
    with _solver_clock(dev) as clock:
        res, _ = tes.run(tes.parse_args(EX_LENET + ["--platform", platform]),
                         **quiet)
    _ex_rows(res, "lenet", tag, dense_min=EX_DENSE_MIN)
    dep = res["unstructured_deployment"]
    print(f"examples lenet: unstructured deployment at "
          f"{dep['sparsity']:.0%}: live blocks {dep['blocks_before']} -> "
          f"{dep['blocks_after_permute']}, block density "
          f"{dep['block_density_after_densify']}, accuracy "
          f"{dep['acc_after_pipeline']:.4f}; {_clock_line(clock)}; "
          f"{time.perf_counter() - t0:.1f} s wall {tag}")
    no_launches("lenet")

    # 10b. AlexNet: docs/EXPERIMENTS_alexnet.md's recipe
    argv = EX_ALEXNET + (EX_ALEXNET_FULL if full else EX_ALEXNET_SHORT)
    args = tes.parse_args(argv + ["--platform", platform])
    t0 = time.perf_counter()
    with _solver_clock(dev) as clock:
        res, exp = tes.run(args, **quiet)
    wall = time.perf_counter() - t0
    _ex_rows(res, "alexnet", tag)
    row, s = res["rows"][0], exp.solver
    losses = clock["losses"]
    if not losses or not all(np.isfinite(losses)):
        raise SystemExit(f"examples alexnet: a loss is not finite "
                         f"({len(losses)} steps)")
    pruned = []
    for name in ("conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc8"):
        share, n = _zero_block_share(s.params[name]["w"].cpu().numpy(),
                                     exp.block)
        pruned.append((name, share, n))
        if abs(share - row["target_sparsity"]) > 1.0 / n:
            raise SystemExit(f"examples alexnet: {name} has {share:.4f} of "
                             f"its {n} blocks zero, not "
                             f"{row['target_sparsity']} within one block")
    print(f"examples alexnet ({' '.join(argv)}): losses finite, "
          f"{losses[0]:.4f} first, {losses[-1]:.4f} last; zero "
          f"{exp.block[0]}x{exp.block[1]} blocks " + ", ".join(
              f"{n} {sh:.4f} of {b}" for n, sh, b in pruned)
          + f" (limit {row['target_sparsity']} +- one block) ok; "
          f"{_clock_line(clock)}; {wall:.1f} s wall {tag}")
    no_launches("alexnet (XBSP scoring)")
    # the same aligned weights on the kernel routes
    pol = dataclasses.replace(exp.sparse_net.policy, use_xla_sparse=False)
    specs = tes.model_specs(args.model, args.filler, include_loss=True)
    knet = Net(specs, policy=pol, phase="test", device=dev)
    aligned = knet.weight_align(s.params)
    ted, tel = exp.test_data
    b = args.batch
    shapes = {"data": (b,) + ted.shape[1:], "label": (b,)}
    routes = knet.routes(aligned, shapes)
    expect = knet.launches(aligned, shapes)
    head = next(l.spec.bottoms[0] for l in knet.layers
                if l.spec.type == "SoftmaxWithLoss")
    state = params_to(s.net_state, dev)
    fwd = knet.inference_fn(params_to(aligned, dev), state=state,
                            return_blobs=True)
    fwd_d = exp.test_net.inference_fn(params_to(s.params, dev), state=state,
                                      return_blobs=True)
    batches = [{"data": torch.as_tensor(ted[i:i + b]).to(dev),
                "label": torch.as_tensor(tel[i:i + b]).to(dev)}
               for i in range(0, len(ted) - b + 1, b)]
    for m in mods.values():
        m.reset_counts()
    got = torch.cat([fwd(x)[head].float() for x in batches])
    counted = launches()
    ref = torch.cat([fwd_d(x)[head].float() for x in batches])
    rel = _rel_l2(got, ref)
    labels = np.concatenate([tel[i:i + b] for i in
                             range(0, len(ted) - b + 1, b)])
    acc_k = float((got.argmax(-1).cpu().numpy() == labels).mean())
    ok = (all(counted[k] == len(batches) * expect[k] for k in mods)
          and expect["sconv_fused"] >= 4 and rel <= LOGITS_REL_L2
          and abs(acc_k - row["acc_sparse_exec"]) <= EX_DELTA)
    print(f"examples alexnet kernel routes (use_xla_sparse=False): routes "
          f"{dict(collections.Counter(routes.values()))}, launches over "
          f"{len(batches)} batches of {b} {counted} (expected "
          f"{len(batches)} x {dict(expect)}); {head} vs the same weights "
          f"dense f32 rel L2 {rel:.3e} (limit {LOGITS_REL_L2:g}); accuracy "
          f"dense {row['acc_finetuned']:.4f}, XBSP "
          f"{row['acc_sparse_exec']:.4f}, kernel routes {acc_k:.4f} (limit "
          f"{EX_DELTA:.4f} from XBSP): "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("examples alexnet on the kernel routes failed")
    for k, n in counted.items():
        results[k]["launches"] += n
    del exp, s, fwd, fwd_d, aligned, got, ref, batches
    if cuda:
        torch.cuda.empty_cache()

    # 10c. the siamese pair at its defaults
    for m in mods.values():
        m.reset_counts()
    t0 = time.perf_counter()
    r = siamese_digits.run(Namespace(iters=400, batch=64, base_lr=0.02,
                                     platform=platform), **quiet)
    shared = "conv1_p" not in r["solver"].params
    ok = shared and r["neg"] > r["pos"]
    print(f"examples siamese_digits (400 iterations, b64): one parameter "
          f"copy {shared}, mean distance positive {r['pos']:.3f}, negative "
          f"{r['neg']:.3f}, pair accuracy at 0.5 {r['pair_acc']:.3f}; "
          f"{time.perf_counter() - t0:.1f} s wall "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("examples siamese_digits failed")
    no_launches("siamese_digits")

    # 10d. net surgery
    t0 = time.perf_counter()
    err, shape = net_surgery.run(platform, EX_SURGERY_CLASSES, **quiet)
    print(f"examples net_surgery (CaffeNet, {EX_SURGERY_CLASSES} classes): "
          f"227x227 score map vs the classifier max abs err {err:.3e} "
          f"(limit {net_surgery.PARITY_TOL:g}); 451x451 -> score map "
          f"{shape}; {time.perf_counter() - t0:.1f} s wall ok {tag}")
    no_launches("net_surgery")
    print(f"examples phase: {time.perf_counter() - t_phase:.1f} s wall "
          f"(budget {EX_BUDGET_S} s{', full length' if full else ''}) "
          f"{tag}")


def _phase_bench(mods, tag, results, dev):
    """Phase 11: the port's bench in process, each run of BENCH_RUNS as
    ``bench.main(argv)`` with the launch counts set to 0 before it; see the
    module docstring. Adds the bare and the forced-fused runs' checked
    forwards and the halo run's launches to ``results``; returns each run's
    (label, mode, JSON line)."""
    import dataclasses
    import hashlib

    import torch
    import torch.nn.functional as F

    from caffe_escoin_tpu_torch import bench
    from caffe_escoin_tpu_torch.engine import autotune
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
    from caffe_escoin_tpu_torch.nn import Net, params_to

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    extra = [] if cuda else ["--platform", "cpu"]
    card = _card_line() if cuda else "cpu"
    record = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "SCALING.jsonl")

    def digest():
        with open(record, "rb") as fh:
            return hashlib.sha256(fh.read()).hexdigest()

    def launched():
        if cuda:
            torch.cuda.synchronize(dev)
        return {k: m.launches for k, m in mods.items()}

    def per_forwards(launches, n=1):
        """``Net.launches``' route kernels, n forwards' worth."""
        return {k: n * launches[k] for k in mods}

    prev_cache = os.environ.get("CESCOIN_AUTOTUNE_CACHE")
    os.environ["CESCOIN_AUTOTUNE_CACHE"] = BENCH_AUTOTUNE_CACHE
    os.makedirs("build", exist_ok=True)
    for path in (BENCH_AUTOTUNE_CACHE, BENCH_ROWS, bench.HALO_RECORD):
        if os.path.exists(path):
            os.remove(path)
    autotune.clear()  # the table starts empty, as on a new machine
    before = digest()
    bare = None  # the bare run's nets, which the forced-fused run reuses
    headlines = []
    try:
        for i, (label, argv, mode, more) in enumerate(BENCH_RUNS):
            for m in mods.values():
                m.reset_counts()
            if mode != "halo":
                argv = argv + ["--jsonl", BENCH_ROWS]
            n_before = _n_lines(BENCH_ROWS)
            t0 = time.perf_counter()
            rc, out = _run_entry(bench.main, argv + extra,
                                 f"build/bench_{i}.log")
            got = launched()
            if rc:
                raise SystemExit(f"bench {label} exited {rc}")
            line = json.loads(out.strip().splitlines()[-1])
            headlines.append((label, mode, line))
            want = BENCH_KEYS[mode] | more | {"device"}
            print(f"bench {label} (python -m caffe_escoin_tpu_torch.bench"
                  f"{''.join(' ' + a for a in argv)}): {json.dumps(line)}; "
                  f"launches over the "
                  f"run {got}; {time.perf_counter() - t0:.1f} s wall {tag}")
            if set(line) != want:
                raise SystemExit(f"bench {label}: keys {sorted(line)}, "
                                 f"expected {sorted(want)}")
            if line["device"] != card:
                raise SystemExit(f"bench {label}: device {line['device']!r}"
                                 f", expected {card!r}")
            if not line["value"] > 0:
                raise SystemExit(f"bench {label}: value {line['value']}")
            if label == "bare":
                bare_run_got = got
                if not got["sconv_fused"]:
                    raise SystemExit("the bare bench launched no sconv_fused")
                # the bare run's nets again (seed 0): the calibrated routes,
                # one forward per input, its logits against dense f32
                args = bench.parse_args(argv + extra)
                bare = bench.prepare_e2e(args, dev)
                n_measured = len(autotune.report())
                with autotune.net_scope(args.model):
                    routes = bare.net_s.routes(bare.aligned, bare.shapes)
                    declared = bare.net_s.launches(bare.aligned, bare.shapes)
                    fwd = bare.net_s.inference_fn(bare.aligned,
                                                  return_blobs=True)
                    for m in mods.values():
                        m.reset_counts()
                    outs = [fwd({"data": x})[BENCH_LOGITS].float()
                            for x in bare.xs]
                    fwd_got = launched()
                if len(autotune.report()) != n_measured:
                    raise SystemExit("bench bare: an arm was measured after "
                                     "the run: its table was not complete")
                expect = per_forwards(declared, len(bare.xs))
                # the sparse net's own pruned weights, dense in f32 (the
                # bench's dense arms hold the unpruned ones)
                dense = Net(bare.net_s.specs, policy=ExecutionPolicy(
                    )).inference_fn(params_to(bare.pruned_s, dev),
                                    return_blobs=True)
                num = den = 0.0
                for x, o in zip(bare.xs, outs):
                    ref = dense({"data": x})[BENCH_LOGITS]
                    if not torch.isfinite(o).all():
                        raise SystemExit("bench bare: logits not finite")
                    num += (o - ref).pow(2).sum().item()
                    den += ref.pow(2).sum().item()
                rel_l2 = (num / den) ** 0.5
                print(f"bench bare, its sparse net again: calibrated routes "
                      f"{dict(collections.Counter(routes.values()))}; "
                      f"launches over {len(bare.xs)} forwards {fwd_got} "
                      f"(expected {expect}); {BENCH_LOGITS} logits vs its "
                      f"weights dense in f32: rel L2 {rel_l2:.3e} (limit "
                      f"{LOGITS_REL_L2:.0e}) "
                      f"{tag}")
                if fwd_got != expect or not fwd_got["sconv_fused"]:
                    raise SystemExit("bench bare: its sparse forward did not "
                                     "launch what its routes name")
                if not rel_l2 <= LOGITS_REL_L2:
                    raise SystemExit("bench bare: the sparse net disagrees "
                                     "with dense f32")
                for k, n in fwd_got.items():
                    results[k]["launches"] += n
                bare_check = (routes, fwd_got, outs)
                del fwd, dense
            elif label == "bare weights-as-args":
                # the bare run's nets again, with the calibrated table as
                # this run left it: the forward over grafted payloads
                # against the closed-over one (and, where the routes are
                # the bare run's, against the bare run's checked forwards)
                if line["weights_as_args"] is not True:
                    raise SystemExit(f"bench {label}: weights_as_args "
                                     f"{line['weights_as_args']}")
                args = bench.parse_args(argv + extra)
                logits, fwd_launches = {}, {}
                with autotune.net_scope(args.model):
                    routes = bare.net_s.routes(bare.aligned, bare.shapes)
                    declared = bare.net_s.launches(bare.aligned, bare.shapes)
                    for flag in (False, True):
                        fwd = bare.net_s.inference_fn(
                            bare.aligned, return_blobs=True,
                            weights_as_args=flag)
                        for m in mods.values():
                            m.reset_counts()
                        logits[flag] = [fwd({"data": x})[BENCH_LOGITS]
                                        .float() for x in bare.xs]
                        fwd_launches[flag] = launched()
                b_routes, b_launches, b_outs = bare_check
                same = all(torch.equal(a, b) for a, b in
                           zip(logits[False], logits[True]))
                as_bare = routes == b_routes
                where = "the bare run's" if as_bare else "recalibrated"
                print(f"bench {label}: launches over the run {got} (the "
                      f"bare run's {bare_run_got}); its sparse forward "
                      f"over {len(bare.xs)} inputs, payloads as arguments: "
                      f"launches {fwd_launches[True]}, closed over "
                      f"{fwd_launches[False]}; {BENCH_LOGITS} bit-equal "
                      f"{same}; routes {where} {tag}")
                if fwd_launches[True] != fwd_launches[False] or not same:
                    raise SystemExit(f"bench {label}: the forward over "
                                     f"grafted payloads differs from the "
                                     f"closed-over one")
                if fwd_launches[True] != per_forwards(declared, len(bare.xs)) \
                        or not fwd_launches[True]["sconv_fused"]:
                    raise SystemExit(f"bench {label}: launches "
                                     f"{fwd_launches[True]} are not what "
                                     f"its routes name")
                if as_bare and (fwd_launches[True] != b_launches or not all(
                        torch.equal(a, b) for a, b in
                        zip(logits[True], b_outs))):
                    raise SystemExit(f"bench {label}: differs from the "
                                     f"bare run on its routes")
                for k, n in fwd_launches[True].items():
                    results[k]["launches"] += n
                del logits, fwd
            elif label == "e2e xbsp-arm fused":
                # the same weights as the bare run's; on the card
                # device_time runs each of its 4 inputs once eagerly and
                # once in a capture (a replay runs no wrapper), on the CPU
                # once eagerly and then each timed call
                net = Net(bare.net_s.specs, policy=dataclasses.replace(
                    bare.net_s.policy, autotune=False, xbsp_arm="fused"))
                args = bench.parse_args(argv + extra)
                n_fwd = len(bare.xs) + (len(bare.xs) if cuda
                                        else max(args.repeats, 8))
                expect = per_forwards(net.launches(bare.aligned, bare.shapes),
                                      n_fwd)
                print(f"bench {label}: launches {got}, expected {expect} "
                      f"({n_fwd} forwards of what Net.routes names) {tag}")
                if got != expect or not got["sconv_fused"]:
                    raise SystemExit(f"bench {label} launched {got}, "
                                     f"expected {expect}")
                for k, n in got.items():
                    results[k]["launches"] += n
            elif label == "per-layer b32":
                args = bench.parse_args(argv + extra)
                items, _ = bench.per_layer_items(args)
                with open(BENCH_ROWS) as fh:  # this run's rows, its headline
                    rows = [json.loads(r) for r in fh][n_before:-1]
                # a config whose pruned weight is not sparse enough has no
                # BSC and no row (dense in both arms)
                cases = [c for c in bench.per_layer_cases(args, items)
                         if c[4].bsc is not None]
                if len(rows) != len(cases):
                    raise SystemExit(f"bench {label}: {len(rows)} rows for "
                                     f"{len(cases)} sparse configs")
                for row, (key, _, xs, wp, _) in zip(rows, cases):
                    h, w, cin, cout, k, s, p, g = key
                    ref = F.conv2d(
                        torch.from_numpy(xs[0]).to(dev).permute(0, 3, 1, 2),
                        torch.from_numpy(wp).to(dev).permute(3, 2, 0, 1),
                        stride=s, padding=p, groups=g)
                    peak = ref.abs().max().item()
                    limit = PARITY_REL * peak + PARITY_ABS
                    ok = row["err"] <= limit and (
                        row["h"], row["cin"], row["cout"], row["k"]) == (
                            h, cin, cout, k)
                    print(f"bench {label} {h}x{w} {cin}->{cout} k{k} "
                          f"x{row['count']}: f32 {row['t_dense_f32_us']} us, "
                          f"bf16 {row['t_dense_bf16_us']} us, sparse "
                          f"{row['t_sparse_us']} us, bound {row['bound_us']} "
                          f"us at {row['stream_rate_tb_s']} TB/s; err "
                          f"{row['err']:.3e} (limit {limit:.3e}) "
                          f"{'ok' if ok else 'FAIL'} {tag}")
                    if not ok:
                        raise SystemExit(f"bench {label}: {key} err "
                                         f"{row['err']}")
            elif label == "halo b16":
                if not got["sconv_gc"]:
                    raise SystemExit("bench --halo launched no sconv_gc")
                with open(bench.HALO_RECORD) as fh:
                    rows = [json.loads(r) for r in fh][-line["rows"] - 1:-1]
                errs = [r["err"] for r in rows
                        if r["metric"] == "halo_overhead_1dev"]
                chain_errs = [r["err_chain"] for r in rows if "layers" in r]
                print(f"bench {label}: {len(rows)} rows in "
                      f"{bench.HALO_RECORD}; halo vs sconv_gc on the whole "
                      f"map max err {errs} (must be 0); one-entry chain vs "
                      f"the convs in sequence {chain_errs} (must be 0); "
                      f"tower errs "
                      f"{[r['err'] for r in rows if 'layers' in r]} {tag}")
                if any(errs):
                    raise SystemExit("bench --halo differs from sconv_gc")
                if not chain_errs or any(chain_errs):
                    raise SystemExit(f"bench --halo: the one-entry chain "
                                     f"differs from the convs in sequence: "
                                     f"{chain_errs}")
                for k, n in got.items():
                    results[k]["launches"] += n
            elif label == "batch-curve":
                if len(line["rows"]) != len(bench.CURVE_BATCHES):
                    raise SystemExit(f"bench {label}: rows {line['rows']}")
            elif label == "e2e unstructured" and any(got.values()):
                raise SystemExit(f"bench {label} launched {got}: every "
                                 f"block is live, every route dense")
            if cuda:
                torch.cuda.empty_cache()
    finally:
        if prev_cache is None:
            os.environ.pop("CESCOIN_AUTOTUNE_CACHE", None)
        else:
            os.environ["CESCOIN_AUTOTUNE_CACHE"] = prev_cache
    if digest() != before:
        raise SystemExit("bench appended to the JAX package's SCALING.jsonl")
    wall = time.perf_counter() - t_phase
    print(f"bench phase: {wall:.1f} s wall (budget {BENCH_BUDGET_S} s) {tag}")
    return headlines


def _n_lines(path) -> int:
    if not os.path.exists(path):
        return 0
    with open(path) as fh:
        return sum(1 for _ in fh)


def _phase_report(headlines, tag, card):
    """Phase 12: phase 11's records rendered by ``tools/report``; see the
    module docstring. ``headlines``: phase 11's (label, mode, line)."""
    from caffe_escoin_tpu_torch import bench
    from caffe_escoin_tpu_torch.tools import report

    t0 = time.perf_counter()
    try:
        sweep = report.load(BENCH_ROWS)
        scaling = report.load(bench.HALO_RECORD)
    except report.RefusedRow as e:
        raise SystemExit(f"report: {e}")
    text = report.render(sweep, scaling, "build")
    out = report.write(text, os.path.join("build", report.TABLES))
    lines = text.splitlines()
    titles = [t for t in lines if t.startswith("## ")]
    unheaded = [t for t in titles if not t.endswith(report.HEADING_SEP + card)]
    if not titles or unheaded:
        raise SystemExit(f"report: sections not headed by {card!r}: "
                         f"{unheaded or 'no section'}")

    def row_of(cells):
        return "| " + " | ".join(str(c) for c in cells) + " |"

    def group(h):  # report.headline_table's key: one row per group
        return tuple(h.get(k) for k in ("metric", "batch", "autotune",
                                         "calibrated", "xbsp_arm", "fused",
                                         "packed"))

    missing = []
    for label, mode, h in headlines:
        if mode == "e2e":
            # the table shows a group's best capture (bare, with and
            # without --weights-as-args, is one group)
            h = min((g for _, m, g in headlines
                     if m == "e2e" and group(g) == group(h)),
                    key=lambda g: g["t_sparse_ms"])
            want = [row_of([h["metric"], h["batch"], f"{h['value']}x",
                            f"{h['speedup_vs_dense_f32']}x",
                            h["t_sparse_ms"], h["t_dense_bf16_ms"]])[:-2]]
        elif mode == "per_layer":
            want = [row_of([h["metric"], h["batch"], f"{h['value']}x",
                            f"{h['speedup_vs_dense_f32']}x",
                            h["gnnz_per_s"]])]
        elif mode == "fc":
            want = [row_of([h["metric"], h["batch"], f"{h['value']}x",
                            f"{h['speedup_vs_dense_f32']}x"])]
        elif mode == "batch_curve":
            model = h["metric"].split("_sparse_batch_curve_peak")[0]
            want = [f"Peak {h['value']} img/s."] + [
                row_of([model, b, r["t_ms"], ips]) for (b, ips), r in zip(
                    h["rows"], [r for r in sweep
                                if r.get("kind") == "batch_curve"])]
        else:  # halo: its single-conv rows
            want = [row_of([f"{r['h']}x{r['w']} {r['cin']}->{r['cout']}",
                            r["backend"], r["t_plain_us"], r["t_halo_us"],
                            f"{r['overhead'] * 100:+.1f}%"])
                    for r in scaling
                    if r.get("metric") == "halo_overhead_1dev"]
        found = [w for w in want if any(ln.startswith(w) for ln in lines)]
        print(f"report: bench {label}: {len(found)} of {len(want)} lines "
              f"in the tables {tag}")
        if not want or len(found) != len(want):
            missing.append((label, [w for w in want if w not in found]))
    print(f"report: {len(sweep)} + {len(scaling)} rows -> {out} "
          f"({len(lines)} lines, {len(titles)} sections, each headed by "
          f"{card!r}); {time.perf_counter() - t0:.1f} s {tag}")
    if missing:
        raise SystemExit(f"report: phase 11 runs missing from the tables: "
                         f"{missing}")


def _phase_experiments(mods, tag, results, dev):
    """Phase 13: the probes in process, each run of EXP_RUNS as
    ``main(argv)`` with the launch counts set to 0 before it; see the module
    docstring. Adds each run's launches to ``results``."""
    import importlib

    import torch

    from caffe_escoin_tpu_torch.engine import autotune
    from caffe_escoin_tpu_torch.experiments import common, s2d

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    extra = [] if cuda else ["--platform", "cpu"]
    prev = {k: os.environ.get(k) for k in ("CESCOIN_AUTOTUNE_CACHE",)}
    # absolute: stability's phases run in processes of their own
    os.environ["CESCOIN_AUTOTUNE_CACHE"] = os.path.abspath(EXP_AUTOTUNE_CACHE)
    os.makedirs(common.OUT_DIR, exist_ok=True)
    for _, name, _ in EXP_RUNS:
        path = os.path.join(common.OUT_DIR, f"{name}.jsonl")
        if os.path.exists(path):
            os.remove(path)
    if os.path.exists(EXP_AUTOTUNE_CACHE):
        os.remove(EXP_AUTOTUNE_CACHE)
    autotune.clear()  # the table starts empty, as on a new machine

    def fail(label, why):
        raise SystemExit(f"experiments {label}: {why}")

    def within(err, scale):
        return err <= PARITY_REL * scale + PARITY_ABS

    try:
        for i, (label, name, argv) in enumerate(EXP_RUNS):
            mod = importlib.import_module(
                f"caffe_escoin_tpu_torch.experiments.{name}")
            for m in mods.values():
                m.reset_counts()
            t0 = time.perf_counter()
            rc, out = _run_entry(mod.main, argv + extra,
                                 f"build/experiments_{i}.log")
            if cuda:
                torch.cuda.synchronize(dev)
            got = {k: m.launches for k, m in mods.items()}
            wall = time.perf_counter() - t0
            if rc:
                fail(label, f"exited {rc}")
            rows = [json.loads(ln) for ln in out.splitlines()
                    if ln.startswith("{")]
            errors = [r for r in rows if "error" in r]
            if not rows or errors:
                fail(label, f"error rows {errors}" if errors else "no row")
            device = rows[0]["device"]
            if cuda and device != _card_line():
                fail(label, f"device {device!r}")
            for k, n in got.items():
                results[k]["launches"] += n
            if name == "opprofile":
                heads = {r["form"]: r for r in rows
                         if r["kind"] == "opprofile"}
                tables = {f: [r for r in rows if r["kind"] ==
                              "opprofile_kernel" and r["form"] == f]
                          for f in heads}
                for form, h in heads.items():
                    top = tables[form][:10]
                    print(f"experiments {label} {form}: "
                          f"{h['module_total_ms_per_iter']} ms of device "
                          f"work per forward (kernels "
                          f"{h['kernel_ms_per_iter']}, copies "
                          f"{h['copy_ms_per_iter']}), graph {h['graph_ms']} "
                          f"ms, non-kernel share {h['non_kernel_share']}; "
                          f"kernels seen {h['kernels_seen']}; hand kernels "
                          f"per forward {h['hand_calls_per_iter']}, launch "
                          f"counter {h['launches_per_iter']}; top: "
                          + "; ".join(f"{k['us_per_iter']} us "
                                      f"{k['share']:.1%} {k['kernel'][:40]} "
                                      f"({k['layer']})" for k in top)
                          + f" {tag}")
                if "resnet50" in label:
                    eager = heads["eager"]
                    forms = [f for f in heads if heads[f]["kernels_seen"]]
                    for form in forms:
                        if not any(k["kernel"] == "sconv_fused"
                                   for k in tables[form]):
                            fail(label, f"the {form} kernel table lacks "
                                        f"sconv_fused")
                    calls = eager["hand_calls_per_iter"]["sconv_fused"]
                    counted = eager["launches_per_iter"]["sconv_fused"]
                    if not calls or calls != counted:
                        fail(label, f"sconv_fused {calls} calls per forward "
                                    f"in the profile, the counter "
                                    f"{counted}")
            elif name == "pool":
                if len(rows) != 6:
                    fail(label, f"{len(rows)} rows")
                for r in rows:
                    print(f"experiments pool {r['tag']} {r['shape']} "
                          f"k{r['k']} s{r['s']} p{r['p']}: rw "
                          f"{r['t_rw_us']} us, slice9 {r['t_slice9_us']}, "
                          f"twopass {r['t_twopass_us']}, hand "
                          f"{r['t_hand_us']} (torch.equal) {tag}")
            elif name == "k3":
                for r in rows:
                    ok = within(r["err"], r["ref_max"])
                    print(f"experiments k3 {r['shape']} {r['arm']}: "
                          f"{r['us']} us, err {r['err']:.3e} (limit "
                          f"{PARITY_REL * r['ref_max'] + PARITY_ABS:.3e}) "
                          f"{'ok' if ok else 'FAIL'} {tag}")
                    if not ok:
                        fail(label, f"{r['shape']} {r['arm']} err "
                                    f"{r['err']}")
                fused = [r for r in rows if r["arm"] == "fused_cuda"]
                n_shapes = len(argv[argv.index("--shapes") + 1].split(","))
                if len(fused) != n_shapes or not got["sconv_fused"]:
                    fail(label, f"fused_cuda rows {len(fused)}, sconv_fused "
                                f"launches {got['sconv_fused']}")
            elif name == "s2d":
                if len(rows) != 3 or any(r["rel_err"] > s2d.REL_TOL
                                         for r in rows):
                    fail(label, f"rows {rows}")
                for r in rows:
                    print(f"experiments s2d {r['tag']}: stock "
                          f"{r['t_stock_us']} us, s2d {r['t_s2d_us']} us "
                          f"({r['speedup']}x), rel_err {r['rel_err']} {tag}")
            elif name == "wpack":
                if len(rows) != 9:
                    fail(label, f"{len(rows)} rows")
                for r in rows:
                    ok = "max_err" not in r or within(r["max_err"],
                                                      r["ref_max"])
                    print(f"experiments wpack {r['shape']} {r['arm']}: "
                          f"{r.get('us', r.get('skipped'))} us"
                          + (f", max_err {r['max_err']:.3e}"
                             if "max_err" in r else "")
                          + f" {'ok' if ok else 'FAIL'} {tag}")
                    if not ok:
                        fail(label, f"{r['arm']} max_err {r['max_err']}")
            elif name == "stability":
                phases = [r.get("phase") for r in rows
                          if r.get("kind") == "stability"]
                summary = [r for r in rows
                           if r.get("kind") == "stability_summary"]
                if phases != ["A", "D"] or len(summary) != 1:
                    fail(label, f"phases {phases}")
                for r in rows:
                    print(f"experiments stability {json.dumps(r)} {tag}")
            elif name == "rss_probe":
                iters = [r["iter"] for r in rows]
                if iters != [0, 50, 100, 150, 200]:
                    fail(label, f"iterations {iters}")
                print(f"experiments rss_probe train: VmRSS "
                      f"{[r['rss_mb'] for r in rows]} MB, allocated on the "
                      f"card {[r.get('cuda_allocated_mb') for r in rows]} "
                      f"MB at iterations {iters} {tag}")
            print(f"experiments {label} (python -m "
                  f"caffe_escoin_tpu_torch.experiments.{name}"
                  f"{''.join(' ' + a for a in argv)}): {len(rows)} rows, "
                  f"launches {got}, {wall:.1f} s wall {tag}")
            if cuda:
                torch.cuda.empty_cache()
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t_phase
    print(f"experiments phase: {wall:.1f} s wall (budget {EXP_BUDGET_S} s) "
          f"{tag}")


def main(argv=None) -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU; see the module docstring.")
    ap.add_argument("--examples-full", action="store_true",
                    help="after the build, run phase 10 alone, with 10b at "
                         "the JAX recipe's length (1200 + 800 + 500 steps)")
    args = ap.parse_args(argv)

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from caffe_escoin_tpu_torch.engine import autotune
        from caffe_escoin_tpu_torch.engine.context import (ConvMode,
                                                           ExecutionPolicy)
        from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
        from caffe_escoin_tpu_torch.ops import conv as conv_ops
        from caffe_escoin_tpu_torch.ops import linear as linear_ops
        from caffe_escoin_tpu_torch.utils.benchmark import device_time
        from caffe_escoin_tpu_torch.kernels import (_build, bsc_spmm,
                                                    conv_epilogue, lrn,
                                                    maxpool, sconv_fused,
                                                    sconv_gc, stem_conv)
        from caffe_escoin_tpu_torch.utils import trace
        from caffe_escoin_tpu_torch.models import ZOO
        from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
        from caffe_escoin_tpu_torch.nn.fuse import (fold_stem_s2d,
                                                    pack_narrow_chains)
        from caffe_escoin_tpu_torch.ops import s2d as s2d_ops
        from caffe_escoin_tpu_torch.ops import wpack
        from caffe_escoin_tpu_torch.engine.context import SparseFormat
        from caffe_escoin_tpu_torch.kernels.spmm import ell_spmm
        from caffe_escoin_tpu_torch.sparse import dense_to_bsc, dense_to_ell
        from caffe_escoin_tpu_torch.sparse.weight_align import weight_align
        from caffe_escoin_tpu_torch.utils.pruning import (prune_blocks,
                                                          prune_conv_weight,
                                                          prune_magnitude)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 1
    # the route kernels, whose launches a net's routes name; the phases that
    # run a forward on the kernel routes (4, 4b-4f, 7c) count the op kernels
    # beside them (net_mods), all as ``Net.launches`` declares them
    mods = {"sconv_fused": sconv_fused, "bsc_spmm": bsc_spmm,
            "sconv_gc": sconv_gc}
    net_mods = {**mods, LRN_KERNEL: lrn, MAXPOOL_KERNEL: maxpool,
                EPILOGUE_KERNEL: conv_epilogue, STEM_KERNEL: stem_conv}
    card = _card_line()
    print(card)
    tag = f"[{card}]"
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(dev)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, TF32 off {tag}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    built = trace.snapshot()["spans"].get("setup:kernel_build")
    nvcc = f"nvcc {built['total_s']:.1f} s" if built else "cached"
    print(f"build: {time.perf_counter() - t0:.1f} s ({nvcc}, "
          f"{_build.library_path().name}) {tag}")
    if _build.ptxas_log:
        print("ptxas: " + _ptxas_summary(_build.ptxas_log) + f" {tag}")

    if args.examples_full:
        _phase_examples(mods, tag, collections.defaultdict(
            lambda: {"launches": 0}), dev, full=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 3. kernel parity at main-path shapes -----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng_np = np.random.default_rng(SEED)
    pol_block = ExecutionPolicy(block_shape=BLOCK)
    results = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                       graph_ms=0.0, graph_plain_ms=0.0,
                       graph_library_ms=0.0, bound_ms=0.0, launches=0,
                       bound={"bytes": 0.0, "operations": 0.0})
               for k in (*KERNELS, *KERNELS_F32, LRN_KERNEL,
                         MAXPOOL_KERNEL, EPILOGUE_KERNEL, STEM_KERNEL)}
    timed = []  # (kernel, label, {arm: fn}, args, bytes, flops)

    def check(kernel, label, out, ref):
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        bound = PARITY_REL * scale + PARITY_ABS
        ok = bool(torch.isfinite(out).all()) and err <= bound
        print(f"parity {kernel} {label}: max_abs_err {err:.3e} "
              f"(bound {bound:.3e}, max|ref| {scale:.3e}) "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"{kernel} {label}: disagrees with its "
                             f"reference")
        if kernel in results:
            results[kernel]["err"] = max(results[kernel]["err"], err)

    def conv_weight(cin, cout, k, rng=rng_np, dtype=torch.bfloat16):
        w = prune_conv_weight(
            rng.standard_normal((k, k, cin, cout)).astype("float32")
            * (2.0 / (k * k * cin)) ** 0.5, SPARSITY, (min(128, cin), 128))
        b = rng.standard_normal(cout).astype("float32") * 0.1
        return weight_align(w, b, policy=pol_block).to(dev, dtype)

    def conv_case(batch, h, cin, cout, k, with_res, g=gen, rng=rng_np,
                  dtype=torch.bfloat16):
        al = conv_weight(cin, cout, k, rng, dtype)
        xs = [torch.randn((batch, h, h, cin), generator=g, device=dev
                          ).to(dtype) for _ in range(N_INPUTS)]
        res = (torch.randn((batch, h, h, cout), generator=g, device=dev
                           ).to(dtype) if with_res else None)
        return al, xs, res

    def live_bytes(bsc, size=2):
        bk, bn = bsc.block_shape
        return bsc.nnz_blocks * bk * bn * size

    def live_cols(bsc, n_kb, width):
        """Columns of the activation (x's channels, or A's K columns) that
        some live block reads: the K-block rows with a live block in any
        block-column, taken mod the ``n_kb`` K-blocks one row of the
        activation spans (a 3x3 conv's nine offsets share x's channels),
        each clipped to ``width``."""
        bk = bsc.block_shape[0]
        rows, nnz = bsc.block_row.cpu(), bsc.bcol_nnz.cpu()
        live = torch.arange(rows.shape[1])[None, :] < nnz[:, None]
        blocks = {int(r) % n_kb for r in rows[live].tolist()}
        return sum(max(0, min(bk, width - b * bk)) for b in blocks)

    def conv_work(al, x, with_res):
        """(bytes, FLOPs) of a stride-1 same-size conv (every timed conv
        keeps its spatial size): the channels of x that a live block reads,
        the live blocks, out and the residual once each, at x's item size;
        two FLOPs per multiply-add of the live blocks."""
        bk, bn = al.bsc.block_shape
        size = x.element_size()
        m = x.shape[0] * x.shape[1] * x.shape[2]
        x_cols = live_cols(al.bsc, al.cin_pad // bk, al.cin)
        out = m * al.cout * size
        return (m * x_cols * size + live_bytes(al.bsc, size)
                + out * (2 if with_res else 1),
                2 * m * al.bsc.nnz_blocks * bk * bn)

    def conv_library(al, pad, dtype=torch.bfloat16):
        """cuDNN on the dense weight in ``dtype``, channels_last, with bias
        and the weight's groups: one library call for the conv (no residual
        or ReLU); ``pad`` is an int or an (H, W) pair. TF32 is off."""
        w = al.dense.to(dev, dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b = al.bias.to(dev, dtype)
        pad = tuple(pad) if isinstance(pad, tuple) else (pad, pad)
        return lambda x: F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=pad,
                                  groups=al.groups)

    sconv_shapes = [  # (label, batch, h, cin, cout, k, pad, relu, residual)
        ("b32 56x56 64->64 3x3", 32, 56, 64, 64, 3, 1, False, False),
        ("b32 14x14 1024->256 1x1", 32, 14, 1024, 256, 1, 0, False, False),
        ("b32 7x7 512->2048 1x1 +res+relu", 32, 7, 512, 2048, 1, 0, True,
         True),
        ("conv3_1 b16 56x56 128->256 3x3 +relu", 16, 56, 128, 256, 3, 1,
         True, False),
        ("conv4_2 b16 28x28 512->512 3x3 +relu", 16, 28, 512, 512, 3, 1,
         True, False),
        ("conv5_2 b16 14x14 512->512 3x3 +relu", 16, 14, 512, 512, 3, 1,
         True, False),
    ]
    for label, batch, h, cin, cout, k, pad, relu, with_res in sconv_shapes:
        al, xs, res = conv_case(batch, h, cin, cout, k, with_res)

        def kern(x, al=al, pad=pad, relu=relu, res=res):
            return sconv_fused.sconv(x, al, padding=(pad, pad), relu=relu,
                                     residual=res)

        def plain(x, al=al, pad=pad, relu=relu, res=res):
            return sconv_fused.sconv_plain(x, al, padding=(pad, pad),
                                           relu=relu, residual=res,
                                           mxu_dtype="bfloat16")

        print(f"plan sconv_fused {label}: "
              f"{sconv_fused.launch_plan(xs[0].shape, al, (pad, pad))} {tag}")
        out = kern(xs[0])
        torch.cuda.synchronize()
        check("sconv_fused", label, out, plain(xs[0]))
        timed.append(("sconv_fused", label,
                      {"kernel": kern, "plain": plain,
                       "library": conv_library(al, pad)}, xs,
                      *conv_work(al, xs[0], with_res)))

    def spmm_case(label, m, bsc, relu, g=gen):
        bias = torch.randn(bsc.shape[1], generator=g, device=dev) * 0.1
        a_list = [torch.randn((m, bsc.shape[0]), generator=g, device=dev
                              ).bfloat16() for _ in range(N_INPUTS)]
        w_dense, bias_bf16 = bsc.to_dense().to(torch.bfloat16), bias.bfloat16()

        def kern(a):
            return bsc_spmm.bsc_spmm(a, bsc, bias=bias, relu=relu)

        def plain(a):
            return bsc_spmm.bsc_spmm_plain(a, bsc, bias=bias, relu=relu,
                                           mxu_dtype="bfloat16")

        def library(a):
            return torch.addmm(bias_bf16, a, w_dense)

        out = kern(a_list[0])
        torch.cuda.synchronize()
        check("bsc_spmm", label, out, plain(a_list[0]))
        bk, bn = bsc.block_shape
        a_cols = live_cols(bsc, bsc.n_brows, bsc.shape[0])
        timed.append(("bsc_spmm", label, {"kernel": kern, "plain": plain,
                                          "library": library}, a_list,
                      m * a_cols * 2 + live_bytes(bsc)
                      + m * bsc.shape[1] * 2,
                      2 * m * bsc.nnz_blocks * bk * bn))

    for label, m, k, n, relu in [  # the fc layers, 128x128 blocks
            ("fc1000 32x2048->1000", 32, 2048, 1000, False),
            ("fc6 16x25088->4096 +relu", 16, 25088, 4096, True),
            ("fc7 16x4096->4096 +relu", 16, 4096, 4096, True),
            ("fc8 16x4096->1000", 16, 4096, 1000, False)]:
        w = prune_blocks(rng_np.standard_normal((k, n)).astype("float32")
                         * (3.0 / k) ** 0.5, SPARSITY, BLOCK)
        spmm_case(label, m, dense_to_bsc(w, BLOCK).to(dev, torch.bfloat16),
                  relu)
    # conv1_2's lowered route: its im2col [16*224*224, 9*64] against the
    # GEMM-view weight, which weight_align cuts in 64x64 blocks
    spmm_case("conv1_2 lowered b16 802816x576->64 +relu", 16 * 224 * 224,
              conv_weight(64, 64, 3).bsc, True)

    gc_shapes = [  # (label, batch, h, cin, cout): VGG-16 3x3 pad-1 layers
        ("conv2_1 b16 112x112 64->128 3x3 +relu", 16, 112, 64, 128),
        ("conv2_2 b16 112x112 128->128 3x3 +relu", 16, 112, 128, 128),
        ("conv3_2 b16 56x56 256->256 3x3 +relu", 16, 56, 256, 256),
    ]
    for label, batch, h, cin, cout in gc_shapes:
        al, xs, _ = conv_case(batch, h, cin, cout, 3, False)

        def gc_kern(x, al=al):
            return sconv_gc.sconv(x, al, padding=(1, 1), relu=True)

        def gc_plain(x, al=al):
            return sconv_gc.sconv_plain(x, al, padding=(1, 1), relu=True,
                                        mxu_dtype="bfloat16")

        def fused_kern(x, al=al):
            return sconv_fused.sconv(x, al, padding=(1, 1), relu=True)

        for name, mod in (("sconv_gc", sconv_gc),
                          ("sconv_fused", sconv_fused)):
            print(f"plan {name} {label}: "
                  f"{mod.launch_plan(xs[0].shape, al, (1, 1))} {tag}")
        out, out_fused = gc_kern(xs[0]), fused_kern(xs[0])
        torch.cuda.synchronize()
        ref = gc_plain(xs[0])
        check("sconv_gc", label, out, ref)
        check("sconv_fused", label, out_fused, ref)
        timed.append(("sconv_gc", label, {"kernel": gc_kern,
                                          "plain": gc_plain,
                                          "library": conv_library(al, 1),
                                          "sconv_fused": fused_kern}, xs,
                      *conv_work(al, xs[0], False)))

    # the packed layout's shapes (phase 4d): each weight repacked from a
    # logical weight pruned as the nets' are, drawn from generators of their
    # own so that the rows above and the nets below keep their inputs
    gen_p = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng_p = np.random.default_rng(SEED + 1)
    for (label, batch, h, wp, cin, cout, k, r_in, r_out, sw, relu, with_res,
         kernels) in PACKED_SHAPES:
        w = prune_conv_weight(
            rng_p.standard_normal((k, k, cin, cout)).astype("float32")
            * (2.0 / (k * k * cin)) ** 0.5, SPARSITY, BLOCK)
        w_in = wp * r_in  # the logical width (a strided 1x1's W stride is
        # the packed 1 after its subsampling: s_p = sw * r_out / r_in)
        wpk, (pl, _), _ = wpack.repack_weight(w, r_in, r_out, sw,
                                              (k - 1) // 2, w_in)
        b = np.tile(rng_p.standard_normal(cout).astype("float32") * 0.1,
                    r_out)
        al = weight_align(wpk, b, policy=pol_block).to(dev, torch.bfloat16)
        pad = ((k - 1) // 2, pl)
        xs = [torch.randn((batch, h, wp, r_in * cin), generator=gen_p,
                          device=dev).bfloat16() for _ in range(N_INPUTS)]
        res = (torch.randn((batch, h, wp, al.cout), generator=gen_p,
                           device=dev).bfloat16() if with_res else None)
        fns = {}  # kernel -> (entry, plain version)
        for name in kernels:
            mod = mods[name]
            extra = {"residual": res} if name == "sconv_fused" else {}
            print(f"plan {name} {label}: "
                  f"{mod.launch_plan(xs[0].shape, al, pad)} {tag}")
            fns[name] = (
                lambda x, mod=mod, al=al, pad=pad, relu=relu, extra=extra:
                mod.sconv(x, al, padding=pad, relu=relu, **extra),
                lambda x, mod=mod, al=al, pad=pad, relu=relu, extra=extra:
                mod.sconv_plain(x, al, padding=pad, relu=relu,
                                mxu_dtype="bfloat16", **extra))
            out = fns[name][0](xs[0])
            torch.cuda.synchronize()
            check(name, label, out, fns[name][1](xs[0]))
        first = kernels[0]
        timed.append((first, label, {
            "kernel": fns[first][0], "plain": fns[first][1],
            "library": conv_library(al, pad),
            **{n: fns[n][0] for n in kernels[1:]}}, xs,
            *conv_work(al, xs[0], with_res)))

    # GoogLeNet's and AlexNet's shapes (ZOO_SHAPES) and AlexNet's fc6, from
    # generators of their own, like the packed shapes
    gen_z = torch.Generator(device=dev).manual_seed(SEED + 2)
    rng_z = np.random.default_rng(SEED + 2)
    for label, batch, h, cin, cout, k, pad, groups in ZOO_SHAPES:
        w0 = rng_z.standard_normal((k, k, cin // groups, cout)).astype(
            "float32") * (2.0 / (k * k * cin // groups)) ** 0.5
        w = prune_conv_weight(w0, SPARSITY, BLOCK)
        c0 = cout - cout % BLOCK[1]
        if cout > BLOCK[1] and c0 < cout:  # the part-full last column
            w[k // 2, k // 2, :, c0:] = w0[k // 2, k // 2, :, c0:]
        b = rng_z.standard_normal(cout).astype("float32") * 0.1
        al = weight_align(w, b, groups=groups, policy=pol_block).to(
            dev, torch.bfloat16)
        xs = [torch.randn((batch, h, h, cin), generator=gen_z, device=dev
                          ).bfloat16() for _ in range(N_INPUTS)]

        def kern(x, al=al, pad=pad):
            return sconv_fused.sconv(x, al, padding=(pad, pad), relu=True)

        def plain(x, al=al, pad=pad):
            return sconv_fused.sconv_plain(x, al, padding=(pad, pad),
                                           relu=True, mxu_dtype="bfloat16")

        print(f"plan sconv_fused {label}: block {al.bsc.block_shape}, "
              f"{al.bsc.nnz_blocks} live of {al.bsc.n_brows * al.bsc.n_bcols}"
              f"; {sconv_fused.launch_plan(xs[0].shape, al, (pad, pad))} "
              f"{tag}")
        out = kern(xs[0])
        torch.cuda.synchronize()
        check("sconv_fused", label, out, plain(xs[0]))
        timed.append(("sconv_fused", label,
                      {"kernel": kern, "plain": plain,
                       "library": conv_library(al, pad)}, xs,
                      *conv_work(al, xs[0], False)))
    w = prune_blocks(rng_z.standard_normal((9216, 4096)).astype("float32")
                     * (3.0 / 9216) ** 0.5, SPARSITY, BLOCK)
    spmm_case("alexnet fc6 32x9216->4096 +relu", 32,
              dense_to_bsc(w, BLOCK).to(dev, torch.bfloat16), True, g=gen_z)

    # ---- 3l. the LRN kernel ------------------------------------------------
    _phase_lrn(tag, dev, results["lrn"])

    # ---- 3m. the max-pool kernel -------------------------------------------
    _phase_maxpool(tag, dev, results[MAXPOOL_KERNEL])

    # ---- 3e. the dense conv's epilogue kernel -------------------------------
    _phase_conv_epilogue(tag, dev, results[EPILOGUE_KERNEL])

    # ---- 3s. the stem conv kernel -------------------------------------------
    _phase_stem_conv(tag, dev, results[STEM_KERNEL])

    # ---- 3b. the XBSP arms against the f32 dense conv ----------------------
    def time_line(what, label, arms, args, nbytes, flops):
        """Each arm eager and as a CUDA graph, beside the bound."""
        graph = {arm: _graph_ms(fn, args) for arm, fn in arms.items()}
        eager = {arm: _time_ms(fn, args) for arm, fn in arms.items()}
        bound_ms, bound_by = _bound(nbytes, flops)
        print(f"time {what} {label}, as a CUDA graph (eager): "
              + ", ".join(f"{arm} {graph[arm]:.4f} ({eager[arm]:.4f}) ms"
                          for arm in arms)
              + f"; bound {bound_ms * 1e3:.1f} us ({bound_by}) {tag}")

    xbsp_cases = [  # (label, batch, h, cin, cout, k, pad, relu, residual)
        sconv_shapes[0], sconv_shapes[1], sconv_shapes[2]]
    # the nets below draw their inputs after this phase: keep the generators
    # where the kernel phases left them
    gen_state, np_state = gen.get_state(), rng_np.bit_generator.state
    with torch.inference_mode():
        for label, batch, h, cin, cout, k, pad, relu, with_res in xbsp_cases:
            al, xs, res = conv_case(batch, h, cin, cout, k, with_res)
            geo = dict(padding=(pad, pad), relu=relu)
            ref = conv_ops.conv2d_dense(
                xs[0].float(), al.dense.float(), al.bias,
                residual=None if res is None else res.float(), **geo)
            arms = {name: (lambda x, fn=fn, al=al, res=res, geo=geo:
                           fn(x, al, residual=res, **geo))
                    for name, fn in (("unroll", xbs.conv),
                                     ("gathered", xbs.conv_gathered),
                                     ("gathered_cols",
                                      xbs.conv_gathered_cols))}
            if pad:  # the CESCOIN_XBSP_NOPAD form differs only when padded
                arms.update({f"{name} pad-free": (
                    lambda x, fn=fn: _nopad(fn, x)) for name, fn in
                    list(arms.items())})
            for name, fn in arms.items():
                out = fn(xs[0])
                torch.cuda.synchronize()
                check(f"xbsp {name}", label, out, ref)
            arms["dense bf16 (cuDNN)"] = conv_library(al, pad)
            time_line("xbsp", label, arms, xs,
                      *conv_work(al, xs[0], with_res))
        w = prune_blocks(rng_np.standard_normal((2048, 1000)).astype(
            "float32") * (3.0 / 2048) ** 0.5, SPARSITY, BLOCK)
        bsc = dense_to_bsc(w, BLOCK).to(dev, torch.bfloat16)
        bias = torch.randn(1000, generator=gen, device=dev) * 0.1
        a_list = [torch.randn((32, 2048), generator=gen, device=dev
                              ).bfloat16() for _ in range(N_INPUTS)]
        w_dense = bsc.to_dense()
        out = xbs.spmm(a_list[0], bsc, bias=bias)
        torch.cuda.synchronize()
        check("xbsp spmm", "fc1000 32x2048->1000", out,
              linear_ops.linear(a_list[0].float(), w_dense.float(), bias))
        bias_bf16 = bias.bfloat16()
        time_line("xbsp", "fc1000 32x2048->1000",
                  {"spmm": lambda a: xbs.spmm(a, bsc, bias=bias),
                   "addmm": lambda a: torch.addmm(bias_bf16, a, w_dense)},
                  a_list,
                  32 * live_cols(bsc, bsc.n_brows, 2048) * 2
                  + live_bytes(bsc) + 32 * 1000 * 2,
                  2 * 32 * bsc.nnz_blocks * BLOCK[0] * BLOCK[1])
        # the ELL gather SpMM at res2's 3x3: the ELL of W^T [64, 576]
        # against the im2col's transpose [576, 32*56*56]
        m_ell = 32 * 56 * 56
        w_t = torch.from_numpy(prune_magnitude(
            rng_np.standard_normal((64, 576)).astype("float32")
            * (2.0 / 576) ** 0.5, SPARSITY)).bfloat16()
        ell = dense_to_ell(w_t.float().numpy(), lane_pad=8).to(
            dev, torch.bfloat16)
        w_t = w_t.to(dev)
        w_csr = w_t.to_sparse_csr()
        b_list = [torch.randn((576, m_ell), generator=gen, device=dev
                              ).bfloat16() for _ in range(N_INPUTS)]
        out = ell_spmm(ell, b_list[0])
        torch.cuda.synchronize()
        label = f"res2 3x3 W^T 64x576 ({ell.nnz} nnz, width {ell.width}) @ " \
                f"576x{m_ell}"
        check("ell_spmm", label, out, w_t.float() @ b_list[0].float())
        live_k = int((w_t != 0).any(dim=0).sum())
        time_line("ell", label,
                  {"ell_spmm": lambda b: ell_spmm(ell, b),
                   "torch.sparse.mm (cuSPARSE CSR)":
                       lambda b: torch.sparse.mm(w_csr, b)},
                  b_list,
                  live_k * m_ell * 2 + ell.values.numel() * 6
                  + 64 * m_ell * 4, 2 * ell.nnz * m_ell)
        del b_list, out
    gen.set_state(gen_state)
    rng_np.bit_generator.state = np_state

    # ---- 3f. the kernels multiplying in f32 ---------------------------------
    # phase 3's ResNet-50 and VGG-16 shapes with mxu_dtype="float32": f32
    # weights and activations, each kernel against its plain version computed
    # in f64 on the card; timed eager and as a CUDA graph beside its plain
    # version in f32 and one library call in f32 (TF32 off), and the f32
    # bound. From generators of their own, so that the nets keep their inputs
    gen_f = torch.Generator(device=dev).manual_seed(SEED + 3)
    rng_f = np.random.default_rng(SEED + 3)
    f32_before = {k: (m.launches, m.launches_f32) for k, m in mods.items()}

    def time_kernel(kernel, label, arms, args, nbytes, flops, f32=False):
        """Each arm eager and as a CUDA graph beside the bound (f32
        multiplies: ``BOUND_RATES_F32``), summed into the kernel's results
        (its ``_f32`` variant's with ``f32``)."""
        rates = BOUND_RATES_F32 if f32 else BOUND_RATES
        with torch.inference_mode():
            graph = {arm: _graph_ms(fn, args) for arm, fn in arms.items()}
            eager = {arm: _time_ms(fn, args) for arm, fn in arms.items()}
        bound_ms, bound_by = _bound(nbytes, flops, rates)
        r = results[f"{kernel}_f32" if f32 else kernel]
        for arm in ("kernel", "plain", "library"):
            key = "ms" if arm == "kernel" else f"{arm}_ms"
            r[key] += eager[arm]
            r["graph_" + key] += graph[arm]
        r["bound_ms"] += bound_ms
        # which limit sets the kernel's summed bound
        for k, v in (("bytes", nbytes), ("operations", flops)):
            r["bound"][k] += v / rates[k] * 1e3
        print(f"time {kernel}{' f32' if f32 else ''} {label}, as a CUDA graph "
              f"(eager): " + ", ".join(
                  f"{arm} {graph[arm]:.4f} ({eager[arm]:.4f}) ms"
                  for arm in arms)
              + f"; bound {bound_ms * 1e3:.1f} us ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB at {rates['bytes'] / 1e12:.2f} TB/s, "
              f"{flops / 1e9:.2f} GFLOP at {rates['operations'] / 1e12:.0f} "
              f"TFLOP/s), kernel graph at {bound_ms / graph['kernel']:.1%} of "
              f"it, {graph['kernel'] / graph['library']:.2f}x the library "
              f"{tag}")

    def check_f64(kernel, label, out, ref):
        err = (out.double() - ref).abs().max().item()
        scale = ref.abs().max().item()
        bound = F32_PARITY_REL * scale
        ok = bool(torch.isfinite(out).all()) and err <= bound
        print(f"parity {kernel} f32 {label}: max_abs_err {err:.3e} = "
              f"{err / scale:.2e} max|ref| (bound {bound:.3e} = "
              f"{F32_PARITY_REL:.0e} max|ref|, max|ref| {scale:.3e}; ref: the "
              f"plain version in f64) {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"{kernel} {label}: multiplying in f32, "
                             f"disagrees with its f64 reference")
        r = results[f"{kernel}_f32"]
        r["err"] = max(r["err"], err)

    t_3f = time.perf_counter()
    for label, batch, h, cin, cout, k, pad, relu, with_res in sconv_shapes:
        al, xs, res = conv_case(batch, h, cin, cout, k, with_res, gen_f,
                                rng_f, torch.float32)
        geo = dict(padding=(pad, pad), relu=relu, residual=res)

        def kern(x, al=al, geo=geo):
            return sconv_fused.sconv(x, al, mxu_dtype="float32", **geo)

        def plain(x, al=al, geo=geo):
            return sconv_fused.sconv_plain(x, al, mxu_dtype="float32", **geo)

        plan = sconv_fused.launch_plan(xs[0].shape, al, (pad, pad),
                                       "float32")
        print(f"plan sconv_fused f32 {label}: {plan} {tag}")
        out = kern(xs[0])
        torch.cuda.synchronize()
        check_f64("sconv_fused", label, out, sconv_fused.sconv_plain(
            xs[0].double(), al, padding=(pad, pad), relu=relu,
            residual=None if res is None else res.double(),
            mxu_dtype="float32"))
        time_kernel("sconv_fused", label,
                    {"kernel": kern, "plain": plain,
                     "library": conv_library(al, pad, torch.float32)}, xs,
                    *conv_work(al, xs[0], with_res), f32=True)
        del al, xs, res, out
    for label, m, k, n, relu in [  # the fc layers, 128x128 blocks
            ("fc1000 32x2048->1000", 32, 2048, 1000, False),
            ("fc6 16x25088->4096 +relu", 16, 25088, 4096, True),
            ("fc7 16x4096->4096 +relu", 16, 4096, 4096, True),
            ("fc8 16x4096->1000", 16, 4096, 1000, False),
            ("conv1_2 lowered b16 802816x576->64 +relu", 16 * 224 * 224, None,
             None, True)]:
        if k is None:  # conv1_2's im2col against its 64x64-block weight
            bsc = conv_weight(64, 64, 3, rng_f, torch.float32).bsc
        else:
            bsc = dense_to_bsc(prune_blocks(
                rng_f.standard_normal((k, n)).astype("float32")
                * (3.0 / k) ** 0.5, SPARSITY, BLOCK), BLOCK).to(dev)
        bias = torch.randn(bsc.shape[1], generator=gen_f, device=dev) * 0.1
        a_list = [torch.randn((m, bsc.shape[0]), generator=gen_f, device=dev)
                  for _ in range(N_INPUTS)]
        w_dense = bsc.to_dense()

        def kern(a, bsc=bsc, bias=bias, relu=relu):
            return bsc_spmm.bsc_spmm(a, bsc, bias=bias, relu=relu,
                                     mxu_dtype="float32")

        def plain(a, bsc=bsc, bias=bias, relu=relu):
            return bsc_spmm.bsc_spmm_plain(a, bsc, bias=bias, relu=relu,
                                           mxu_dtype="float32")

        print(f"plan bsc_spmm f32 {label}: "
              f"{bsc_spmm.launch_plan(m, bsc, 'float32')} {tag}")
        out = kern(a_list[0])
        torch.cuda.synchronize()
        check_f64("bsc_spmm", label, out, bsc_spmm.bsc_spmm_plain(
            a_list[0].double(), bsc, bias=bias, relu=relu,
            mxu_dtype="float32"))
        bk, bn = bsc.block_shape
        time_kernel("bsc_spmm", label,
                    {"kernel": kern, "plain": plain,
                     "library": lambda a, w=w_dense, b=bias:
                         torch.addmm(b, a, w)}, a_list,
                    (m * live_cols(bsc, bsc.n_brows, bsc.shape[0])
                     + m * bsc.shape[1]) * 4 + live_bytes(bsc, 4),
                    2 * m * bsc.nnz_blocks * bk * bn, f32=True)
        del bsc, a_list, w_dense, out
    for label, batch, h, cin, cout in gc_shapes:
        al, xs, _ = conv_case(batch, h, cin, cout, 3, False, gen_f, rng_f,
                              torch.float32)

        def kern(x, al=al):
            return sconv_gc.sconv(x, al, padding=(1, 1), relu=True,
                                  mxu_dtype="float32")

        def plain(x, al=al):
            return sconv_gc.sconv_plain(x, al, padding=(1, 1), relu=True,
                                        mxu_dtype="float32")

        print(f"plan sconv_gc f32 {label}: "
              f"{sconv_gc.launch_plan(xs[0].shape, al, (1, 1), 'float32')} "
              f"{tag}")
        out = kern(xs[0])
        torch.cuda.synchronize()
        check_f64("sconv_gc", label, out, sconv_gc.sconv_plain(
            xs[0].double(), al, padding=(1, 1), relu=True,
            mxu_dtype="float32"))
        time_kernel("sconv_gc", label,
                    {"kernel": kern, "plain": plain,
                     "library": conv_library(al, 1, torch.float32)}, xs,
                    *conv_work(al, xs[0], False), f32=True)
        del al, xs, out
    f32_launched = {k: (m.launches - f32_before[k][0],
                        m.launches_f32 - f32_before[k][1])
                    for k, m in mods.items()}
    launched_f32 = {k: v[1] for k, v in f32_launched.items()}
    print(f"phase 3f: launches of the f32 kernels (parity and timing, not "
          f"counted in the kernels line) {launched_f32}, "
          f"{time.perf_counter() - t_3f:.1f} s wall {tag}")
    if any(total != f32 for total, f32 in f32_launched.values()) or \
            not all(f32 for _, f32 in f32_launched.values()):
        raise SystemExit(f"phase 3f launched other than the f32 kernels: "
                         f"{f32_launched}")
    torch.cuda.empty_cache()

    # ---- 4. the nets ------------------------------------------------------
    def launches_of(fwd, inputs, expect, what, f32=False):
        """Each kernel launched N_INPUTS x what ``expect`` (the net's
        ``Net.launches``) names, every launch in f32 with ``f32`` and none
        without; counted into the kernel's results (a route kernel's
        ``_f32`` variant's with ``f32``). Returns the forwards' outputs."""
        want = {k: expect[k] for k in net_mods}
        for m in net_mods.values():
            m.reset_counts()
        outs = [fwd(i) for i in inputs]
        torch.cuda.synchronize()
        got = {k: m.launches for k, m in net_mods.items()}
        got_f32 = {k: m.launches_f32 for k, m in net_mods.items()}
        print(f"net {what} launches over {N_INPUTS} forwards: {got}"
              + (f", of them in f32 {got_f32}" if f32 else "")
              + f" (expected {N_INPUTS} x {want}) {tag}")
        for name, n in got.items():
            if (n != N_INPUTS * want[name]
                    or got_f32[name] != (n if f32 else 0)):
                raise SystemExit(f"{what} launched {name} {n} times ("
                                 f"{got_f32[name]} in f32), expected "
                                 f"{N_INPUTS * want[name]}")
            f32_variant = f32 and name in KERNELS
            results[f"{name}_f32" if f32_variant else name]["launches"] += n
        return outs

    pol_s = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                            compute_dtype=torch.bfloat16, cast_back=False,
                            use_xla_sparse=False)
    e2e = []  # (model, batch, {arm: fn}, inputs f32, inputs bf16)
    kept = {}  # model -> what the autotuned row reuses
    for cfg in NETS:
        model, batch = cfg["model"], cfg["batch"]
        logits_blob, width = cfg["logits"], cfg["width"]
        t0 = time.perf_counter()
        build, shapes = ZOO[model]
        shapes = {"data": (batch,) + tuple(shapes["data"][1:])}
        net = Net(build(), policy=pol_s)
        params = net.init(torch.Generator().manual_seed(SEED), shapes)
        pruned = _prune(net, params, keep_norm=cfg["keep_norm"])
        fnet, fparams = fuse_inference(net, pruned, state=net.state0)
        aligned = fnet.weight_align(fparams)
        routes = fnet.routes(aligned, shapes)
        t1 = time.perf_counter()
        for _ in range(ROUTE_REPS):
            fnet.routes(aligned, shapes)
        route_us = ((time.perf_counter() - t1) / ROUTE_REPS / len(routes)
                    * 1e6)
        expect = fnet.launches(aligned, shapes)
        sparse_params = params_to(aligned, dev, torch.bfloat16)
        dense_net = Net(fnet.specs, policy=ExecutionPolicy())
        dense_params = params_to(fparams, dev)
        dense_bf16_net = Net(fnet.specs, policy=ExecutionPolicy(
            compute_dtype=torch.bfloat16, cast_back=False))
        dense_bf16_params = params_to(fparams, dev, torch.bfloat16)
        xs = [torch.randn(shapes["data"], generator=gen, device=dev)
              * cfg["input_scale"] for _ in range(N_INPUTS)]
        print(f"net: {model} b{batch} {shapes['data'][1]}x"
              f"{shapes['data'][2]}, {len(net.layers)} -> {len(fnet.layers)} "
              f"layers after fusion, {SPARSITY:.0%} sparsity in "
              f"{BLOCK[0]}x{BLOCK[1]} blocks, set-up "
              f"{time.perf_counter() - t0:.1f} s; routes "
              f"{dict(collections.Counter(routes.values()))}; expected "
              f"launches per forward: {dict(expect)} {tag}")
        print(f"net {model} routing host time: {route_us:.2f} us per layer "
              f"(Net.routes over {len(routes)} conv/fc layers, mean of "
              f"{ROUTE_REPS}, host clock) {tag}")

        fwd_s = fnet.inference_fn(sparse_params, return_blobs=True)
        fwd_d = dense_net.inference_fn(dense_params, return_blobs=True)
        fwd_db = dense_bf16_net.inference_fn(dense_bf16_params)
        sparse_out = launches_of(fwd_s, [{"data": x} for x in xs], expect,
                                 model)
        num, den, peak = 0.0, 0.0, 0.0
        for x, so in zip(xs, sparse_out):
            prob, logits = so["prob"], so[logits_blob].float()
            if prob.shape != (batch, width) or not torch.isfinite(prob).all() \
                    or not torch.isfinite(logits).all():
                raise SystemExit(f"{model} output is not finite "
                                 f"[{batch}, {width}]")
            if (prob.float().sum(-1) - 1).abs().max().item() > 2e-2:
                raise SystemExit(f"{model} softmax rows do not sum to 1")
            ref = fwd_d({"data": x})[logits_blob]
            num += (logits - ref).pow(2).sum().item()
            den += ref.pow(2).sum().item()
            peak = max(peak, ref.abs().max().item())
        rel_l2 = (num / den) ** 0.5
        ok = rel_l2 <= LOGITS_REL_L2
        print(f"net {model} {logits_blob} logits vs dense f32: rel L2 "
              f"{rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}), max|logit| "
              f"{peak:.3e} {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"sparse {model} disagrees with dense f32")
        kept[model] = dict(net=net, init=params, specs=fnet.specs,
                           params=sparse_params, xs=xs, fnet=fnet,
                           fparams=fparams, shapes=shapes, fwd_s=fwd_s,
                           fwd_d=fwd_d, logits=logits_blob, routes=routes)
        e2e.append((model, batch, fnet.layers, routes,
                    {"sparse": fwd_s, "dense-bf16": fwd_db,
                     "dense-f32": fwd_d},
                    [{"data": x} for x in xs],
                    [{"data": x.bfloat16()} for x in xs]))
        del sparse_out

    # the later phases' checks: logits against the row's dense f32 net, and
    # launches against what the routes name
    def logits_rel_l2(fwd, row, what):
        num = den = 0.0
        for x in row["xs"]:
            out = fwd({"data": x})
            logits = out[row["logits"]].float()
            if not torch.isfinite(logits).all() or \
                    not torch.isfinite(out["prob"].float()).all():
                raise SystemExit(f"{what}: output is not finite")
            ref = row["fwd_d"]({"data": x})[row["logits"]]
            num += (logits - ref).pow(2).sum().item()
            den += ref.pow(2).sum().item()
        return (num / den) ** 0.5

    # ---- 4b. ResNet-50 b32 autotuned ---------------------------------------
    row = kept["resnet50"]
    os.makedirs(os.path.dirname(AUTOTUNE_CACHE), exist_ok=True)
    pol_at = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                             compute_dtype=torch.bfloat16, cast_back=False,
                             use_xla_sparse=True, autotune=True,
                             autotune_cache=AUTOTUNE_CACHE)
    at_net = Net(row["specs"], policy=pol_at)
    at_inputs = [{"data": x} for x in row["xs"]]
    at_fwd = at_net.inference_fn(row["params"], return_blobs=True)

    def fwd_at(inputs):
        with autotune.net_scope("resnet50"):
            return at_fwd(inputs)

    def time_sparse():
        # captures the forward anew: the trials change its routes
        return device_time(lambda y: fwd_at({"data": y})["prob"],
                           row["xs"][0], iters=CALIB_REPS,
                           arg_sets=[(x,) for x in row["xs"]])

    def calibrate_from_empty(time_fn, net, params, shapes, net_tag, what):
        """One ``calibrate_graph`` (polish 8) under ``net_tag`` from an
        emptied cache: its ``calib`` line, every key's isolated arm times,
        each key held to every arm (``_check_arms``). Returns its
        result."""
        if os.path.exists(AUTOTUNE_CACHE):
            os.remove(AUTOTUNE_CACHE)
        autotune.clear()
        t0 = time.perf_counter()
        calib = autotune.calibrate_graph(
            time_fn, polish=CALIB_POLISH, net_tag=net_tag,
            cache_path=AUTOTUNE_CACHE,
            log=lambda m: print(f"calib-log {what}: {m}", flush=True))
        wall = time.perf_counter() - t0
        measured = autotune.report()
        n_keys, n_fused = _check_arms(net, params, shapes, measured)
        print(f"calib {what}, from an empty cache: t_first "
              f"{calib['t_first'] * 1e3:.3f} ms, t_isolated "
              f"{calib['t_isolated'] * 1e3:.3f} ms, t_dense "
              f"{calib['t_dense'] * 1e3:.3f} ms, t_final "
              f"{calib['t_final'] * 1e3:.3f} ms; flips {calib['flips']}, "
              f"polish trials {calib.get('polish_trials', 0)}; "
              f"{calib['keys']} keys, {calib['sparse_keys']} sparse, "
              f"{n_keys} measured on every arm, fused on the {n_fused} the "
              f"dispatcher would run it on; arms "
              f"{dict(collections.Counter(calib['arms'].values()))}; "
              f"measurement + calibration {wall:.1f} s wall {tag}")
        for key, times in sorted(measured.items()):
            print(f"autotune {what} key {key}: " + " ".join(
                f"{arm}={t * 1e6:.1f}us" for arm, t in sorted(times.items()))
                + f" -> {min(times, key=times.get)} {tag}")
        return calib

    x_mb = row["xs"][0].numel() * row["xs"][0].element_size() / 1e6
    print(f"calib timing: device_time of the whole forward, CUDA-graph "
          f"replays, median of {CALIB_REPS}, cycling {N_INPUTS} inputs of "
          f"{x_mb:.1f} MB (resnet50 b32; autotune.measure: 4 synthetic inputs "
          f"per key) {tag}")
    picks = []  # per run: key -> arm
    for run in range(CALIB_RUNS):
        calib = calibrate_from_empty(
            time_sparse, at_net, row["params"], row["shapes"], "resnet50",
            f"resnet50 b32 autotuned, run {run + 1} of {CALIB_RUNS}")
        picks.append(calib["arms"])
    keys = sorted(set().union(*picks))
    agree = [k for k in keys if len({p.get(k) for p in picks}) == 1]
    for k in keys:
        print(f"calib arms per run, key {k}: "
              + ", ".join(str(p.get(k)) for p in picks) + f" {tag}")
    print(f"calib: the {CALIB_RUNS} runs picked the same arm on "
          f"{len(agree)} of {len(keys)} keys: "
          f"{'agree' if len(agree) == len(keys) else 'DIFFER'} {tag}")
    n_measured = len(autotune.report())
    with autotune.net_scope("resnet50"):
        at_routes = at_net.routes(row["params"], row["shapes"])
        at_expect = at_net.launches(row["params"], row["shapes"])
    if len(autotune.report()) != n_measured:
        raise SystemExit("Net.routes measured an arm: the cache was not "
                         "complete after calibration")
    print(f"net resnet50 autotuned routes (served from the last run's "
          f"cache): {dict(collections.Counter(at_routes.values()))}; "
          + ", ".join(f"{n} {r}" for n, r in at_routes.items()) + f" {tag}")
    at_out = launches_of(fwd_at, at_inputs, at_expect, "resnet50 autotuned")
    num = den = 0.0
    for inputs, out in zip(at_inputs, at_out):
        logits = out["fc1000"].float()
        if not torch.isfinite(logits).all() or \
                not torch.isfinite(out["prob"].float()).all():
            raise SystemExit("autotuned resnet50 output is not finite")
        ref = row["fwd_d"](inputs)["fc1000"]
        num += (logits - ref).pow(2).sum().item()
        den += ref.pow(2).sum().item()
    rel_l2 = (num / den) ** 0.5
    ok = rel_l2 <= LOGITS_REL_L2
    print(f"net resnet50 autotuned fc1000 logits vs dense f32: rel L2 "
          f"{rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}) "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("autotuned resnet50 disagrees with dense f32")
    # the graph form of inference_fn: its first call per input shape runs
    # eagerly and captures, later calls copy the input in and replay
    at_graph_fwd = at_net.inference_fn(row["params"], cuda_graph=True)

    def fwd_at_graph(inputs):
        with autotune.net_scope("resnet50"):
            return at_graph_fwd(inputs)

    for inputs, out in zip(at_inputs[:2] * 2, at_out[:2] * 2):
        got = fwd_at_graph(inputs)["prob"].float()
        err = (got - out["prob"].float()).abs().max().item()
        if err > PARITY_REL * out["prob"].float().abs().max().item():
            raise SystemExit(f"inference_fn(cuda_graph=True) differs from "
                             f"the eager forward by {err:.3e}")
    del at_out
    at_ms = {}
    arms_of = (("kernel routes", row["fwd_s"]), ("autotuned", fwd_at))
    for label, fn in arms_of:
        at_ms[f"{label} eager"] = _time_ms(fn, at_inputs)
    # the graph times in the order kernel, autotuned, autotuned, kernel,
    # each side the mean of its two readings: a drift of the card's speed
    # across the readings falls on both sides alike
    readings = collections.defaultdict(list)
    for label, fn in arms_of + arms_of[::-1]:
        readings[label].append(_graph_ms(fn, at_inputs, N_INPUTS))
    for label, got in readings.items():
        at_ms[f"{label} as a CUDA graph"] = statistics.fmean(got)
    at_ms["autotuned through inference_fn(cuda_graph=True)"] = _time_ms(
        fwd_at_graph, at_inputs)
    if len(autotune.report()) != n_measured:
        raise SystemExit("an arm was measured after calibration")
    ratio = (at_ms["autotuned as a CUDA graph"]
             / at_ms["kernel routes as a CUDA graph"])
    ok = ratio <= AUTOTUNED_GRAPH_LIMIT
    times = ", ".join(f"{k} {v:.3f} ms" for k, v in at_ms.items())
    graph_readings = "; ".join(
        f"{label} graph readings " + " ".join(f"{t:.3f}" for t in got)
        for label, got in readings.items())
    print(f"time resnet50 b32: {times} ({graph_readings} ms); autotuned "
          f"graph / kernel-route graph {ratio:.3f} (limit "
          f"{AUTOTUNED_GRAPH_LIMIT}) {'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        # stderr carries what a failed run needs to be read: the times and
        # every route the calibration gave other than the fused kernel's
        others = {n: r for n, r in at_routes.items() if r != "fused"}
        raise SystemExit(f"the autotuned forward as a CUDA graph takes "
                         f"{ratio:.3f}x the kernel route's: {times} "
                         f"({graph_readings} ms); autotuned routes "
                         f"{dict(collections.Counter(at_routes.values()))}, "
                         f"the layers not on fused: {others} {tag}")
    with autotune.net_scope("resnet50"):
        per = _layer_split(at_net.layers, fwd_at, at_inputs[0])
    by_arm, n_arm = collections.Counter(), collections.Counter()
    for name, t in per.items():
        by_arm[at_routes.get(name, "other")] += t
        n_arm[at_routes.get(name, "other")] += 1
    print(f"layers resnet50 autotuned, device ms per forward, each layer "
          f"alone as a CUDA graph: sum {sum(per.values()):.3f}; by arm "
          + ", ".join(f"{r} {t:.3f} ({n_arm[r]} layers)"
                      for r, t in by_arm.most_common())
          + "; by layer " + ", ".join(
              f"{n} ({at_routes.get(n, '-')}) {t:.4f}"
              for n, t in sorted(per.items(), key=lambda kv: -kv[1]))
          + f" {tag}")
    del at_graph_fwd

    # GoogLeNet b32 and AlexNet b32 autotuned, on their kernel-route rows'
    # weights and inputs: one calibration each from an emptied cache
    # (polish 8, under the net's scope); the autotuned / kernel-route graph
    # ratio is reported
    autotuned_ratio = {}
    for model in CALIB_ONCE:
        zrow = kept[model]
        z_net = Net(zrow["specs"], policy=pol_at)
        z_inputs = [{"data": x} for x in zrow["xs"]]
        z_fwd = z_net.inference_fn(zrow["params"], return_blobs=True)

        def fwd_z(inputs, z_fwd=z_fwd, model=model):
            with autotune.net_scope(model):
                return z_fwd(inputs)

        def time_z(fwd_z=fwd_z, zrow=zrow):
            return device_time(lambda y: fwd_z({"data": y})["prob"],
                               zrow["xs"][0], iters=CALIB_REPS,
                               arg_sets=[(x,) for x in zrow["xs"]])

        batch = zrow["xs"][0].shape[0]
        calibrate_from_empty(time_z, z_net, zrow["params"], zrow["shapes"],
                             model, f"{model} b{batch} autotuned")
        n_measured = len(autotune.report())
        with autotune.net_scope(model):
            z_routes = z_net.routes(zrow["params"], zrow["shapes"])
            z_expect = z_net.launches(zrow["params"], zrow["shapes"])
        if len(autotune.report()) != n_measured:
            raise SystemExit(f"{model}: Net.routes measured an arm after "
                             f"calibration")
        print(f"net {model} autotuned routes (served from the cache): "
              f"{dict(collections.Counter(z_routes.values()))} {tag}")
        launches_of(fwd_z, z_inputs, z_expect, f"{model} autotuned")
        rel_l2 = logits_rel_l2(fwd_z, zrow, f"autotuned {model}")
        ok = rel_l2 <= LOGITS_REL_L2
        print(f"net {model} autotuned {zrow['logits']} logits vs dense f32: "
              f"rel L2 {rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}) "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"autotuned {model} disagrees with dense f32")
        z_ms = {}
        for label, fn in (("kernel routes", zrow["fwd_s"]),
                          ("autotuned", fwd_z)):
            z_ms[f"{label} as a CUDA graph"] = _graph_ms(fn, z_inputs,
                                                         N_INPUTS)
            z_ms[f"{label} eager"] = _time_ms(fn, z_inputs)
        if len(autotune.report()) != n_measured:
            raise SystemExit(f"{model}: an arm was measured after "
                             f"calibration")
        ratio = (z_ms["autotuned as a CUDA graph"]
                 / z_ms["kernel routes as a CUDA graph"])
        autotuned_ratio[model] = ratio
        print(f"time {model} b{batch}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in z_ms.items())
            + f"; autotuned graph / kernel-route graph {ratio:.3f} "
            f"(reported, not a limit yet) {tag}")
        with autotune.net_scope(model):
            per = _layer_split(z_net.layers, fwd_z, z_inputs[0])
        by_arm, n_arm = collections.Counter(), collections.Counter()
        for name, t in per.items():
            by_arm[z_routes.get(name, "other")] += t
            n_arm[z_routes.get(name, "other")] += 1
        print(f"layers {model} autotuned, device ms per forward, each layer "
              f"alone as a CUDA graph: sum {sum(per.values()):.3f}; by arm "
              + ", ".join(f"{r} {t:.3f} ({n_arm[r]} layers)"
                          for r, t in by_arm.most_common())
              + "; the convs and fcs by time " + ", ".join(
                  f"{n} ({r}) {per[n]:.4f}" for n, r in sorted(
                      z_routes.items(), key=lambda kv: -per[kv[0]]))
              + f" {tag}")
        del z_fwd
    print("autotuned / kernel-route graph time: " + ", ".join(
        f"{k} {v:.3f}" for k, v in autotuned_ratio.items())
        + f" (resnet50 held to {AUTOTUNED_GRAPH_LIMIT} above) {tag}")

    # ---- 4c. ResNet-50 b32 unstructured, through ELL -----------------------
    t0 = time.perf_counter()
    pruned = _prune(row["net"], row["init"], block=None)
    fnet, fparams = fuse_inference(row["net"], pruned,
                                   state=row["net"].state0)
    pol_ell = ExecutionPolicy(conv_mode=ConvMode.LOWERED_SPARSE,
                              sparse_format=SparseFormat.ELL,
                              block_shape=BLOCK, compute_dtype=torch.bfloat16,
                              cast_back=False)
    ell_net = Net(fnet.specs, policy=pol_ell)
    aligned = ell_net.weight_align(fparams)
    ell_routes = ell_net.routes(aligned, row["shapes"])
    n_ell = sum(r == "ell" for r in ell_routes.values())
    print(f"net resnet50 b32 unstructured: {SPARSITY:.0%} element-wise, "
          f"LOWERED_SPARSE with ELL, set-up {time.perf_counter() - t0:.1f} "
          f"s; routes {dict(collections.Counter(ell_routes.values()))} "
          f"{tag}")
    if (ell_routes["conv1"], ell_routes["fc1000"], n_ell) != (
            "dense", "dense", len(ell_routes) - 2):
        raise SystemExit(f"unstructured resnet50 routes: conv1 "
                         f"{ell_routes['conv1']}, fc1000 "
                         f"{ell_routes['fc1000']}, {n_ell} ell")
    print("net resnet50 unstructured ELL layers (width, nnz): " + ", ".join(
        f"{n} ({aligned[n].ell_t.width}, {aligned[n].ell_t.nnz})"
        for n, r in ell_routes.items() if r == "ell") + f" {tag}")
    ell_params = params_to(aligned, dev, torch.bfloat16)
    ell_fwd = ell_net.inference_fn(ell_params, return_blobs=True)
    ell_dense = Net(fnet.specs, policy=ExecutionPolicy()).inference_fn(
        params_to(fparams, dev), return_blobs=True)
    for m in mods.values():
        m.reset_counts()
    ell_out = [ell_fwd(i) for i in at_inputs]
    torch.cuda.synchronize()
    ell_launches = {k: m.launches for k, m in mods.items()}
    print(f"net resnet50 unstructured launches over {N_INPUTS} forwards: "
          f"{ell_launches} (expected none: the ELL path runs no hand "
          f"kernel) {tag}")
    if any(ell_launches.values()):
        raise SystemExit("the ELL path launched a kernel")
    num = den = 0.0
    for inputs, out in zip(at_inputs, ell_out):
        logits = out["fc1000"].float()
        if (out["prob"].shape != (32, 1000)
                or not torch.isfinite(logits).all()
                or not torch.isfinite(out["prob"].float()).all()):
            raise SystemExit("unstructured resnet50 output is not finite "
                             "[32, 1000]")
        ref = ell_dense(inputs)["fc1000"]
        num += (logits - ref).pow(2).sum().item()
        den += ref.pow(2).sum().item()
    del ell_out
    rel_l2 = (num / den) ** 0.5
    ok = rel_l2 <= LOGITS_REL_L2
    print(f"net resnet50 unstructured fc1000 logits vs dense f32: rel L2 "
          f"{rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}) "
          f"{'ok' if ok else 'FAIL'} {tag}")
    if not ok:
        raise SystemExit("unstructured resnet50 disagrees with dense f32")
    ell_ms = _time_ms(ell_fwd, at_inputs, iters=2 * N_INPUTS)
    per = _layer_split(ell_net.layers, ell_fwd, at_inputs[0])
    by_route = collections.Counter()
    for name, t in per.items():
        by_route[ell_routes.get(name, "other")] += t
    print(f"time resnet50 b32 unstructured ELL: eager {ell_ms:.3f} ms; "
          f"layers, device ms per forward, each layer alone as a CUDA "
          f"graph: sum {sum(per.values()):.3f}; by route "
          + ", ".join(f"{r} {t:.3f}" for r, t in by_route.most_common())
          + "; by layer " + ", ".join(
              f"{n} ({ell_routes.get(n, '-')}) {t:.4f}"
              for n, t in sorted(per.items(), key=lambda kv: -kv[1]))
          + f" {tag}")
    del ell_fwd, ell_params

    # ---- 4d. the packed layout ----------------------------------------------
    # pack_narrow_chains on the fused sparse nets, as bench.py packs its
    # sparse arm (bench.py:478-490); the rows above stay unpacked
    packed_ratio = {}
    for cfg in NETS:
        model, batch = cfg["model"], cfg["batch"]
        row = kept[model]
        if model == "alexnet":
            # no blob of AlexNet packs (96 channels and more, at widths that
            # give r = 1), as bench.py's --pack leaves it: hold that here
            if pack_narrow_chains(row["fnet"]) is not row["fnet"]:
                raise SystemExit("pack_narrow_chains now packs AlexNet: give "
                                 "it a PACKED_LAUNCHES entry")
            print(f"net {model} b{batch} packed: nothing packs {tag}")
            continue
        if model not in PACKED_LAUNCHES:
            continue  # GoogLeNet's packed form is phase 4e's
        inputs = [{"data": x} for x in row["xs"]]
        t0 = time.perf_counter()
        pnet = pack_narrow_chains(row["fnet"])
        p_params = params_to(pnet.weight_align(row["fparams"]), dev,
                             torch.bfloat16)
        p_routes = pnet.routes(p_params, row["shapes"])
        expect = pnet.launches(p_params, row["shapes"])
        # the layers that packing changed
        region = [l.spec.name for l in pnet.layers
                  if "pack_in" in l.p or "pack_out" in l.p]
        print(f"net {model} b{batch} packed: {len(pnet.packed_blobs)} blobs "
              f"{pnet.packed_blobs}, set-up {time.perf_counter() - t0:.1f} "
              f"s; routes {dict(collections.Counter(p_routes.values()))}; "
              f"packed layers: " + ", ".join(
                  f"{n} {p_routes.get(n, '-')}" for n in region) + f" {tag}")
        if _routed(expect) != PACKED_LAUNCHES[model]:
            raise SystemExit(f"packed {model} routes launch "
                             f"{_routed(expect)}, expected "
                             f"{PACKED_LAUNCHES[model]}")
        fwd_p = pnet.inference_fn(p_params, return_blobs=True)
        launches_of(fwd_p, inputs, expect, f"{model} packed")
        rel_l2 = logits_rel_l2(fwd_p, row, f"packed {model}")
        ok = rel_l2 <= LOGITS_REL_L2
        print(f"net {model} packed {row['logits']} logits vs dense f32 "
              f"(unpacked): rel L2 {rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}) "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"packed {model} disagrees with dense f32")
        ms = {}
        for label, fn in (("unpacked", row["fwd_s"]), ("packed", fwd_p)):
            ms[f"{label} as a CUDA graph"] = _graph_ms(fn, inputs, N_INPUTS)
        for label, fn in (("unpacked", row["fwd_s"]), ("packed", fwd_p)):
            ms[f"{label} eager"] = _time_ms(fn, inputs)
        ratio = ms["packed as a CUDA graph"] / ms["unpacked as a CUDA graph"]
        packed_ratio[f"{model} kernel routes"] = ratio
        print(f"time {model} b{batch} kernel routes, packed against "
              f"unpacked: " + ", ".join(f"{k} {v:.3f} ms"
                                        for k, v in ms.items())
              + f"; packed / unpacked graph {ratio:.3f} {tag}")
        per_p = _layer_split(pnet.layers, fwd_p, inputs[0])
        per_u = _layer_split(row["fnet"].layers, row["fwd_s"], inputs[0])
        print(f"layers {model} packed region ({len(region)} layers), device "
              f"ms per forward, each layer alone as a CUDA graph, packed "
              f"(unpacked): sum {sum(per_p[n] for n in region):.3f} "
              f"({sum(per_u[n] for n in region):.3f}); whole forward "
              f"{sum(per_p.values()):.3f} ({sum(per_u.values()):.3f}); "
              + ", ".join(f"{n} ({p_routes.get(n, '-')}) {per_p[n]:.4f} "
                          f"({per_u[n]:.4f})" for n in region) + f" {tag}")
        if model != "resnet50":
            continue
        # ResNet-50 b32 autotuned, packed: one calibration from an empty cache
        at_pnet = Net(pnet.specs, policy=pol_at)
        at_pfwd = at_pnet.inference_fn(p_params, return_blobs=True)

        def fwd_pat(inputs, at_pfwd=at_pfwd):
            with autotune.net_scope("resnet50_packed"):
                return at_pfwd(inputs)

        def time_packed(fwd_pat=fwd_pat, row=row):
            return device_time(lambda y: fwd_pat({"data": y})["prob"],
                               row["xs"][0], iters=CALIB_REPS,
                               arg_sets=[(x,) for x in row["xs"]])

        calibrate_from_empty(time_packed, at_pnet, p_params, row["shapes"],
                             "resnet50_packed",
                             "resnet50 b32 autotuned packed")
        with autotune.net_scope("resnet50_packed"):
            pat_routes = at_pnet.routes(p_params, row["shapes"])
            pat_expect = at_pnet.launches(p_params, row["shapes"])
        print(f"net resnet50 autotuned packed routes (served from the "
              f"cache): {dict(collections.Counter(pat_routes.values()))} "
              f"{tag}")
        launches_of(fwd_pat, inputs, pat_expect, f"{model} autotuned packed")
        rel_l2 = logits_rel_l2(fwd_pat, row, "autotuned packed resnet50")
        ok = rel_l2 <= LOGITS_REL_L2
        print(f"net {model} autotuned packed fc1000 logits vs dense f32: "
              f"rel L2 {rel_l2:.3e} (limit {LOGITS_REL_L2:.0e}) "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit("autotuned packed resnet50 disagrees with "
                             "dense f32")
        pat_ms = _graph_ms(fwd_pat, inputs, N_INPUTS)
        ratio = pat_ms / at_ms["autotuned as a CUDA graph"]
        packed_ratio["resnet50 autotuned"] = ratio
        print(f"time resnet50 b32 autotuned, packed as a CUDA graph "
              f"{pat_ms:.3f} ms against unpacked "
              f"{at_ms['autotuned as a CUDA graph']:.3f} (phase 4b); "
              f"packed / unpacked {ratio:.3f} {tag}")
        del at_pfwd
    print("packed / unpacked graph time: " + ", ".join(
        f"{k} {v:.3f}" for k, v in packed_ratio.items())
        + f" (reported, not a limit) {tag}")

    # ---- 4e. GoogLeNet b32's stem transforms --------------------------------
    # bench.py runs GoogLeNet fused, then folds its stem by space-to-depth
    # (bench.py:466-477), then packs (bench.py:478-490): the three forms on
    # the kernel routes, each checked and timed as a CUDA graph in this call
    row = kept["googlenet"]
    inputs = [{"data": x} for x in row["xs"]]
    snet, sparams = fold_stem_s2d(row["fnet"], row["fparams"])
    s_params = params_to(snet.weight_align(sparams), dev, torch.bfloat16)
    pnet = pack_narrow_chains(snet)
    p_params = params_to(pnet.weight_align(sparams), dev, torch.bfloat16)
    forms = {"fused": (row["fnet"], row["params"]),
             "fused + s2d": (snet, s_params),
             "fused + s2d + pack": (pnet, p_params)}
    fwds = {label: n.inference_fn(prm, return_blobs=True)
            for label, (n, prm) in forms.items()}
    stem_ms, form_ms = {}, collections.defaultdict(list)
    for label, (n, prm) in forms.items():
        fwd = fwds[label]
        f_routes = n.routes(prm, row["shapes"])
        expect = n.launches(prm, row["shapes"])
        stem = n.specs[0].params
        grid = n.layers[0]._in_shape(row["shapes"]["data"])
        print(f"net googlenet b32 {label}: stem kernel {stem['kernel']} "
              f"stride {stem.get('stride', 1)} pad {stem.get('pad', 0)} on "
              f"{grid}; packed blobs {getattr(n, 'packed_blobs', {})}; "
              f"routes {dict(collections.Counter(f_routes.values()))} {tag}")
        launches_of(fwd, inputs, expect, f"googlenet {label}")
        rel_l2 = logits_rel_l2(fwd, row, f"googlenet {label}")
        ok = rel_l2 <= LOGITS_REL_L2
        print(f"net googlenet {label} loss3/classifier logits vs dense f32 "
              f"(unfolded, unpacked): rel L2 {rel_l2:.3e} (limit "
              f"{LOGITS_REL_L2:.0e}) {'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"googlenet {label} disagrees with dense f32")
        per = _layer_split(n.layers, fwd, inputs[0])
        stem_ms[label] = {k: per[k] for k in STEM_LAYERS}
    # the graph times in the order A B C C B A, each form's the mean of two
    order = list(forms) + list(forms)[::-1]
    for label in order:
        form_ms[label].append(_graph_ms(fwds[label], inputs, N_INPUTS))
    base = sum(form_ms["fused"]) / 2
    print("time googlenet b32 stem forms, kernel routes, as a CUDA graph "
          "(mean of two readings, order A B C C B A): " + ", ".join(
              f"{k} {sum(v) / 2:.3f} ms ({v[0]:.3f}, {v[1]:.3f}), "
              f"{sum(v) / 2 / base:.3f}x fused" for k, v in form_ms.items())
          + f" {tag}")
    stem = snet.specs[0].params
    x_bf16 = row["xs"][0].bfloat16()
    s2d_ms = _graph_ms(lambda x: s2d_ops.s2d_input(
        x, stem["s2d_r"], tuple(stem["s2d_kernel"]), tuple(stem["s2d_pad"])),
        [x_bf16])
    print("layers googlenet b32 stem, device ms per forward, each layer "
          "alone as a CUDA graph (its s2d transform included in the folded "
          "conv1), " + "; ".join(
              f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              for label, t in stem_ms.items())
          + f"; the s2d transform alone (space_to_depth and the grid's "
          f"pad, bf16 {tuple(x_bf16.shape)} -> "
          f"{snet.layers[0]._in_shape(x_bf16.shape)}) {s2d_ms:.4f} {tag}")
    del fwds

    # ---- 4f. the nets multiplying in f32 ------------------------------------
    # VGG-16 b16 and ResNet-50 b32 on their phase-4 rows' pruned, fused
    # weights and inputs, in f32 throughout (compute_dtype None) with
    # mxu_dtype="float32": on the kernel routes, then ResNet-50 autotuned with
    # the same multiply type (the f32 fused arm against the XBSP arms and
    # dense, all f32 with TF32 off). Launches against Net.routes, every one
    # multiplying in f32; logits against the row's dense f32 net
    t_4f = time.perf_counter()

    def f32_logits(fwd, row, what):
        rel_l2 = logits_rel_l2(fwd, row, what)
        ok = rel_l2 <= F32_LOGITS_REL_L2
        print(f"net {what} {row['logits']} logits vs dense f32 (TF32 off): "
              f"rel L2 {rel_l2:.3e} (limit {F32_LOGITS_REL_L2:.0e}) "
              f"{'ok' if ok else 'FAIL'} {tag}")
        if not ok:
            raise SystemExit(f"{what} disagrees with dense f32")

    pol_f32 = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                              compute_dtype=None, use_xla_sparse=False,
                              mxu_dtype="float32")
    for model in F32_NETS:
        row = kept[model]
        inputs = [{"data": x} for x in row["xs"]]
        f_net = Net(row["specs"], policy=pol_f32)
        f_params = params_to(f_net.weight_align(row["fparams"]), dev)
        f_routes = f_net.routes(f_params, row["shapes"])
        expect = f_net.launches(f_params, row["shapes"])
        print(f"net {model} b{row['xs'][0].shape[0]} f32 (mxu_dtype float32,"
              f" f32 activations), kernel routes: "
              f"{dict(collections.Counter(f_routes.values()))}; the layers "
              f"whose route differs from the bf16 row's: " + ", ".join(
                  f"{n} {r}" for n, r in f_routes.items()
                  if r != row["routes"].get(n)) + f" {tag}")
        f_fwd = f_net.inference_fn(f_params, return_blobs=True)
        launches_of(f_fwd, inputs, expect, f"{model} f32", f32=True)
        f32_logits(f_fwd, row, f"{model} f32")
        f_graph_fwd = f_net.inference_fn(f_params, cuda_graph=True)
        for inputs_i in inputs[:2] * 2:
            got = f_graph_fwd(inputs_i)["prob"]
            want = f_fwd(inputs_i)["prob"]
            err = (got - want).abs().max().item()
            if err > F32_PARITY_REL * want.abs().max().item():
                raise SystemExit(f"{model} f32: inference_fn(cuda_graph="
                                 f"True) differs from the eager forward by "
                                 f"{err:.3e}")
        arms = (("f32 kernel routes", f_fwd),
                ("bf16 kernel routes", row["fwd_s"]),
                ("dense f32", row["fwd_d"]))
        ms = {}
        for label, fn in arms:
            ms[f"{label} as a CUDA graph"] = _graph_ms(fn, inputs, N_INPUTS)
        for label, fn in arms:
            ms[f"{label} eager"] = _time_ms(fn, inputs)
        ms["f32 kernel routes through inference_fn(cuda_graph=True)"] = \
            _time_ms(f_graph_fwd, inputs)
        graph = {label: ms[f"{label} as a CUDA graph"] for label, _ in arms}
        print(f"time {model} f32: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ms.items())
            + f"; f32 kernel routes / dense f32 graph "
            f"{graph['f32 kernel routes'] / graph['dense f32']:.3f}, / bf16 "
            f"kernel routes graph "
            f"{graph['f32 kernel routes'] / graph['bf16 kernel routes']:.3f}"
            f" {tag}")
        per = _layer_split(f_net.layers, f_fwd, inputs[0])
        kind = {l.spec.name: f_routes.get(l.spec.name) or l.spec.type
                for l in f_net.layers}
        by_route = collections.Counter()
        for name, t in per.items():
            by_route[kind[name]] += t
        print(f"layers {model} f32 kernel routes, device ms per forward, each "
              f"layer alone as a CUDA graph: sum {sum(per.values()):.3f}; by "
              f"route or layer type " + ", ".join(
                  f"{r} {t:.3f}" for r, t in by_route.most_common())
              + f" {tag}")
        del f_graph_fwd
        if model != "resnet50":
            del f_fwd, f_params
            continue
        # ResNet-50 b32 autotuned in f32, calibrated once from an empty cache
        pol_at32 = ExecutionPolicy(
            conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
            use_xla_sparse=True, autotune=True, autotune_cache=AUTOTUNE_CACHE,
            mxu_dtype="float32")
        at_net32 = Net(row["specs"], policy=pol_at32)
        at_fwd32 = at_net32.inference_fn(f_params, return_blobs=True)

        def fwd_at32(inputs_i, at_fwd32=at_fwd32):
            with autotune.net_scope("resnet50_f32"):
                return at_fwd32(inputs_i)

        def time_at32(fwd_at32=fwd_at32, row=row):
            return device_time(lambda y: fwd_at32({"data": y})["prob"],
                               row["xs"][0], iters=CALIB_REPS,
                               arg_sets=[(x,) for x in row["xs"]])

        calibrate_from_empty(time_at32, at_net32, f_params, row["shapes"],
                             "resnet50_f32", "resnet50 b32 autotuned f32")
        n_measured = len(autotune.report())
        with autotune.net_scope("resnet50_f32"):
            at32_routes = at_net32.routes(f_params, row["shapes"])
            at32_expect = at_net32.launches(f_params, row["shapes"])
        if len(autotune.report()) != n_measured:
            raise SystemExit("resnet50 f32: Net.routes measured an arm after "
                             "calibration")
        print(f"net resnet50 autotuned f32 routes (served from the cache): "
              f"{dict(collections.Counter(at32_routes.values()))} {tag}")
        launches_of(fwd_at32, inputs, at32_expect, "resnet50 autotuned f32",
                    f32=True)
        f32_logits(fwd_at32, row, "resnet50 autotuned f32")
        at32_ms = {}
        for label, fn in (("f32 kernel routes", f_fwd),
                          ("autotuned f32", fwd_at32),
                          ("autotuned f32", fwd_at32),
                          ("f32 kernel routes", f_fwd)):
            at32_ms.setdefault(label, []).append(_graph_ms(fn, inputs,
                                                           N_INPUTS))
        if len(autotune.report()) != n_measured:
            raise SystemExit("resnet50 f32: an arm was measured after "
                             "calibration")
        g = {k: statistics.fmean(v) for k, v in at32_ms.items()}
        print(f"time resnet50 b32 autotuned f32 as a CUDA graph "
              f"{g['autotuned f32']:.3f} ms against the f32 kernel routes "
              f"{g['f32 kernel routes']:.3f} (readings kernel, autotuned, "
              f"autotuned, kernel: " + "; ".join(
                  f"{k} " + " ".join(f"{t:.3f}" for t in v)
                  for k, v in at32_ms.items())
              + f"); autotuned / kernel-route graph "
              f"{g['autotuned f32'] / g['f32 kernel routes']:.3f} (reported, "
              f"not a limit) {tag}")
        del at_fwd32, f_fwd, f_params
    print(f"phase 4f: {time.perf_counter() - t_4f:.1f} s wall; launches of "
          f"the f32 kernels over its nets "
          + ", ".join(f"{k} {results[k]['launches']}" for k in KERNELS_F32)
          + f" {tag}")
    torch.cuda.empty_cache()

    # ---- 5. times ---------------------------------------------------------
    sparse_graph_ms = {}  # model -> the sparse forward as a CUDA graph
    for model, batch, layers, routes, arms, inputs, inputs_bf16 in e2e:
        ms = {arm: _time_ms(fn, inputs_bf16 if arm == "dense-bf16"
                            else inputs) for arm, fn in arms.items()}
        ms["sparse as a CUDA graph"] = _graph_ms(arms["sparse"], inputs,
                                                 N_INPUTS)
        ms["dense-bf16 as a CUDA graph"] = _graph_ms(arms["dense-bf16"],
                                                     inputs_bf16, N_INPUTS)
        sparse_graph_ms[model] = ms["sparse as a CUDA graph"]
        print(f"time {model} b{batch}: " + ", ".join(
            f"{arm} {t:.3f} ms" for arm, t in ms.items()) + f" {tag}")
        per = _layer_split(layers, arms["sparse"], inputs[0])
        # a conv or fc by its route, any other layer by its type (LRN,
        # Concat, Pooling, ...)
        kind = {l.spec.name: routes.get(l.spec.name) or l.spec.type
                for l in layers}
        by_route, n_route = collections.Counter(), collections.Counter()
        for name, t in per.items():
            by_route[kind[name]] += t
            n_route[kind[name]] += 1
        top = sorted(per.items(), key=lambda kv: -kv[1])
        print(f"layers {model} sparse, device ms per forward, each layer "
              f"alone as a CUDA graph: sum {sum(per.values()):.3f}; by route "
              f"or layer type " + ", ".join(
                  f"{r} {t:.3f} ({n_route[r]})"
                  for r, t in by_route.most_common())
              + "; by layer " + ", ".join(
                  f"{n} ({routes.get(n, '-')}) {t:.4f}" for n, t in top)
              + f" {tag}")
    # host time of one entry call of each kernel on a tiny input, so each
    # launch's device work ends before the host has issued the next one;
    # the SpMM's splits K (4 shares), so its workspace is allocated too
    tiny = torch.randn((1, 8, 8, 64), generator=gen, device=dev).bfloat16()
    fused_w, gc_w = conv_weight(64, 64, 3), conv_weight(64, 128, 3)
    fc_w = dense_to_bsc(rng_np.standard_normal((512, 128)).astype("float32"),
                        BLOCK).to(dev, torch.bfloat16)
    probes = {  # name -> (what it is handed, one entry call)
        "sconv_fused": ("1x8x8x64 input", lambda: sconv_fused.sconv(
            tiny, fused_w, padding=(1, 1), relu=True)),
        "sconv_gc": ("1x8x8x64 input", lambda: sconv_gc.sconv(
            tiny, gc_w, padding=(1, 1), relu=True)),
        "bsc_spmm": ("8x512 A, 512x128 weight", lambda: bsc_spmm.bsc_spmm(
            tiny.reshape(8, 512), fc_w, relu=True)),
    }
    for name, (what, fn) in probes.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ROUTE_REPS):
            fn()
        host_us = (time.perf_counter() - t0) / ROUTE_REPS * 1e6
        torch.cuda.synchronize()
        print(f"host {name} entry: {host_us:.2f} us per call ({what}, "
              f"mean of {ROUTE_REPS}, host clock) {tag}")
    for kernel, label, arms, args, nbytes, flops in timed:
        time_kernel(kernel, label, arms, args, nbytes, flops)

    # ---- 6. the command line ---------------------------------------------
    torch.cuda.empty_cache()
    _phase_cli(mods, tag)

    # ---- 7. training, then the trained weights on the kernels -------------
    torch.cuda.empty_cache()
    _phase_train(mods, tag, results, sparse_graph_ms["alexnet"])

    # ---- 8. the data slice -------------------------------------------------
    torch.cuda.empty_cache()
    _phase_data(mods, tag, results, dev)

    # ---- 9. parallel/, permute, vision at world size 1 ---------------------
    torch.cuda.empty_cache()
    _phase_parallel(mods, tag, results, dev)

    # ---- 10. the examples: real digits, trained, pruned, scored sparse -----
    torch.cuda.empty_cache()
    _phase_examples(mods, tag, results, dev)

    # ---- 11. the port's bench, as a user runs it ---------------------------
    torch.cuda.empty_cache()
    headlines = _phase_bench(mods, tag, results, dev)

    # ---- 12. its rows rendered as the port's tables -------------------------
    _phase_report(headlines, tag, card)

    # ---- 13. the probes of the sparse forward --------------------------------
    torch.cuda.empty_cache()
    _phase_experiments(mods, tag, results, dev)

    # each kernel, then its f32-multiply variant (same source and TPU
    # kernel; its launches are phase 4f's, its times phase 3f's)
    # and the op kernels, which replace no TPU kernel (their times phases
    # 3l's, 3m's, 3e's and 3s's, their launches the nets' LRN layers, max
    # pools, dense convs and stems in phases 4, 4b-4f and 7c)
    names = [(k, base) for base in KERNELS
             for k in (base, f"{base}_f32")] + [
        (LRN_KERNEL, LRN_KERNEL), (MAXPOOL_KERNEL, MAXPOOL_KERNEL),
        (EPILOGUE_KERNEL, EPILOGUE_KERNEL), (STEM_KERNEL, STEM_KERNEL)]
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": f"caffe_escoin_tpu_torch/csrc/{base}.cu",
         "replaces": KERNELS.get(base), "launches": results[k]["launches"],
         "max_abs_err": results[k]["err"],
         **{key: results[k][key] for key in (
             "ms", "plain_ms", "bound_ms", "library_ms", "graph_ms",
             "graph_plain_ms", "graph_library_ms")},
         "bound_by": max(results[k]["bound"], key=results[k]["bound"].get)}
        for k, base in names]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
