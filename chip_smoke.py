#!/usr/bin/env python3
"""Drive the port (mxnet_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of the repository

Phases, each of which fails the run (non-zero exit) when it fails:

1. build: compile every CUDA kernel source of the port with nvcc, all at
   once, and print the build seconds and ptxas' register/shared-memory use.
2. kernels: at each of the 7 distinct 3x3 convolution shapes of a
   ResNet-50 forward, batch 32, fp32 (the stride-2 ones natively), run the
   hand-written implicit-GEMM kernel (through ``hopper_conv``) against its
   plain PyTorch version on the same CUDA tensors, within rtol = atol =
   1e-4, after ragged, misaligned (storage offset 1: its 4-byte copy path)
   and odd stride-2 shapes.  Every kernel-1 fp32 call runs twice,
   bit-equal, launching the convolution once and its split sum once when
   its plan (``hopper_conv.conv_fp32_plan``) splits the reduction; its
   blocks an SM at each tile, read on the card, must equal the plan's; at
   each shape each tile at 1, 2 and the plan's splits is checked and
   timed, and one stride-2 call is profiled: kernel 1 and its split sum,
   and no kernel but the weight's layout copy.  Print the plan, the
   kernel's time, the kernel's before its redesign (quoted), the plain
   version's and cuDNN's (``F.conv2d``, the yardstick only: the port never
   calls it for these shapes) and the bound, and their sums over a served
   forward.
2b. backward kernels: at each of the 4 stride-1 3x3 shapes of a Gluon
   ResNet-50 v1, batch 32, fp32, kernel 2 (wgrad, ``taps_wgrad.cu``)
   against ``taps_wgrad_plain`` (within 1e-4 of the largest |dw|) and
   kernel 1 as dgrad (flipped, io-swapped taps; bit-equal reruns, its
   plan's launches, its time beside the time before its redesign) against
   the plain version (rtol = atol = 1e-4), after ragged shapes (both of
   kernel 2's tiles, its 2x2 form with the reference's stride-2 pads, an x
   at storage offset 1: its 4-byte copy path); kernel 2 also at batch
   128.  Every kernel-2 call runs twice, bit-equal, launching the partial
   pass once and the reduction pass once when its plan
   (``hopper_conv.wgrad_fp32_plan``) splits the rows; its blocks an SM,
   read on the card, must equal the plan's.  Kernel, plain
   and cuDNN times (``torch.nn.grad.conv2d_weight`` / ``conv2d_input``, the
   yardsticks only), TFLOP/s, the plan's tile and splits and the fp32
   bound, and kernel 2's sums over a batch-32 and a batch-128 step; where
   the whole-wave rule of ``wgrad_bf16_plan`` splits the rows otherwise
   than the plan's cost model, that launch is checked and timed too.
2c. LSTM kernels: kernel 8 (``lstm_fwd.cu``) and kernel 9 (``lstm_bwd.cu``)
   against their plain versions (``hopper_rnn.lstm_fwd_plain`` /
   ``lstm_bwd_plain``) at two ragged shapes, at the edges of their
   envelope (B=1024; H=2048, where R does not stay in shared memory) and
   at the LM's (T=35, B=128, H=650) and at phase 17's shortest and
   longest buckets (T=10 and 40, B=128, H=650): every forward output
   within 1e-5, every backward output within
   1e-4 of its largest |value|, and, at the LM's and the buckets' shapes
   and at H=2048, bit-equal on a rerun; each kernel's launch plan
   (``hopper_rnn.lstm_plan``) beside the blocks an SM the card reports;
   kernel, plain and cuDNN times (``torch.nn.LSTM`` of one layer, the
   yardstick only, with its input projection's matmul and dx timed apart,
   so that cuDNN's recurrence alone is the difference; at the LM's shape
   and at both bucket lengths) beside the kernels' times before their
   redesign (``BEFORE_K89_MS``) and the fp32 bound.
3. serving: serve the full-width ResNet-50 (224 px, 1000 classes, fp32,
   seeded random weights) through ``ModelServer`` on gpu(0) with buckets
   up to 32; answer 8 concurrent requests of 1-8 rows of mixed SLO classes
   and check every answer against a ``Predictor`` on the CPU (the plain
   versions): same top-1, probabilities within 1e-4.  Then a closed loop
   of 8 clients measures images/s and latency; halfway through it the
   server's weights are swapped (``swap_params``) for a second seeded set:
   every answer must match the CPU's on the old or the new weights, and no
   executed batch may mix the two.  The kernel launch counter, zeroed just
   before, must read 16 per executed forward; each kernel-1 call's shape
   is noted, and kernel 1's split sums must equal those its plan gives
   the calls.  Then the gateway: a
   ``ModelRegistry`` of the full-width ResNet-50 (buckets 1-4) and a small
   MLP on gpu(0), routed by name, the HTTP endpoint on 127.0.0.1 port 0
   answering one POST for each model, and a swap through the registry,
   every answer against the CPU's.
4. profile: one batch-32 forward as the server runs it (host copy in,
   forward, host copy out), timed on the host and traced with
   torch.profiler: device busy share and device time by kernel group.
5. training: full-width Gluon ResNet-50 v1 (224 px, batch 32, fp32,
   weights from ``initialize()`` after ``random.seed(0)``) trained by
   ``FusedTrainer`` (SGD, lr 0.1, momentum 0.9) on gpu(0).  The first
   step must match the same step on the CPU from the same weights and
   batch (loss within rtol 1e-4, each 3x3 weight's update within 5% of
   its norm); then 2 warm-up and 10 timed steps give train images/s.  The
   launch counters, zeroed just before the first step, must read per step
   32 kernel-1 launches with one split sum for each whose reduction its
   plan splits (18 on a 132-SM card), 16 launches of kernel 2's partial
   pass and one launch of its reduction pass for each of those 16 whose
   rows its plan splits (all 16 on a 132-SM card).
6. training profile: two steps under torch.profiler, device time and
   launches by group (kernel 1 forward, kernel 1 dgrad, kernel 2's two
   passes, cuDNN, BatchNorm and elementwise, layout copies, optimizer),
   the same kernel launch counts read from the trace, and the device's
   idle share of an unprofiled step.

7. LM training: bench.py's ``bench_lstm_lm`` net at full width (vocab
   33278, embed = hidden = 650, 2 layers, dropout 0.2, bptt 35, batch 128,
   fp32) built through the port's Gluon with deferred shapes, hybridized,
   trained by ``FusedTrainer`` with ``SoftmaxCrossEntropyLoss`` (SGD lr
   0.5) on one batch of token ids below 256: kernels 8 and 9 must launch 2
   times each a step (one per layer), the loss must stay finite and fall
   over 12 steps; train tokens/s from the median of 10 timed steps after 2
   warm-up steps.  Dropout's keep rate at one layer's shape must be 0.8
   within 0.005, and one seed must give the same first loss twice.
7b. LM vs CPU: the first step of the same net without dropout, from the
   same weights, on the card and on the CPU: loss within rtol 1e-4, every
   parameter's update within 1% of its norm.
8. LM profile: one step under torch.profiler, device time and launches by
   group (kernel 8, kernel 9, cuBLAS, cross-entropy, embedding, dropout
   and elementwise, optimizer, memcpy), the ten longest kernels, and the
   idle share.
2d. attention kernels (run after 2c): kernels 3, 5 and 4
   (``flash_attn_fwd.cu``, launched by ``flash_fwd_plan``) and 6 and 7,
   fused into one kernel and its fixed-order dq sum (``flash_attn_bwd.cu``),
   against their plain versions (``hopper_attention.flash_fwd_plain`` /
   ``flash_stats_plain`` / ``flash_bwd_plain``) at the main path's shape
   (B=16, H=12, T=1024, D=64, causal) and five ragged or odd ones (Tq > Tk,
   Tk > Tq, T off the tile, D = 16, 32, 128): out, lse and m within 1e-5,
   acc and l within 1e-5 and dq, dk and dv within 1e-4 of their largest
   |value|, every output bit-equal on a rerun; both kernels' occupancy (CTAs
   an SM by head dim); at the main shape each kernel's time, TFLOP/s and
   bound (the backward's at five products) beside the plain version's and
   the yardstick's (``F.scaled_dot_product_attention``, forward and
   backward), the backward's split between its kernel and its dq sum, and
   the times before the redesigns (``BEFORE_K345_MS``, ``BEFORE_K67_MS``).
9. transformer training: ``bench.py --transformer``'s model,
   ``transformer_lm(gpt2-small)`` (vocab 50257, 12 layers, d_model 768,
   12 heads, d_ff 3072, seq_len 1024, fp32), bound through the port's
   ``Module`` at batch 16, ``Xavier(gaussian, 2)`` after ``random.seed(7)``,
   SGD lr 0.05 momentum 0.9, fed by ``SyntheticLMIter(seed=0)``, trained by
   the fused step: every step must launch kernel 5, the fused backward and
   its dq sum 12 times each and kernel 3 never, the losses must be finite; train tokens/s from the
   median of 10 timed steps after 2 warm-up steps, and MFU
   (``flops_per_token`` x tokens/s over 67 TFLOP/s).  Then one eval forward
   of the same Module must launch kernel 3 12 times and kernel 5 never.
9b. transformer vs CPU: the first step at full width, T=1024, batch 1, all
   12 layers (4 if the CPU step took over 60 s), on the card and on the
   CPU from the same weights: loss within rtol 1e-4, every parameter's
   update within 1% of its norm.
10. transformer profile: one step under torch.profiler, device time and
   launches by group (cuBLAS, kernels 3, 5, the fused 6 and 7 and its dq
   sum, LayerNorm, gelu and elementwise, cross-entropy, embedding, optimizer, memcpy), the attention
   kernels' launches read from the trace, and the idle share.
2e. ring kernels (run after 2d): kernel 4, the stats mode of
   ``flash_attn_fwd.cu``, and with it kernels 3 and 5, against
   ``hopper_attention.flash_stats_plain`` / ``flash_fwd_plain`` at the
   ring's per-shard shape (B=1, H=12, T_loc=4096, D=64, unmasked and
   causal) and five ragged or odd ones: out, lse and m within 1e-5, acc
   and l within 1e-5 of their largest |value|, bit-equal on a rerun;
   kernel 10 (``zero_fill.cu``) against zeros over a NaN buffer of (8,
   128).  Times beside the plain versions', the fp32 bound, the time before
   the redesign (``BEFORE_K345_MS``) and the yardsticks (PyTorch's
   memory-efficient attention with log-sum-exp, the nearest call and not
   the same outputs; ``Tensor.zero_``).  The fused backward at the same two shapes (the
   ring's backward calls): its time, launches and bound beside the plain
   version's and SDPA's memory-efficient backward.
11. long context: ``models.long_context_attention`` at gpt2-small's
   attention geometry (H=12, D=64, fp32), B=1, T=32,768, causal, on
   ``make_mesh({"sp": 8}, [cuda:0] * 8)``, forward and backward of
   ``sum(out * g)``: the counters, zeroed just before, must read 36
   launches of kernel 4 (28 full steps, 8 diagonal ones), 36 each of
   the fused backward and its dq sum, none of 3 or 5, and the one probe of
   kernel 10.  out, dq, dk and dv against one un-sharded
   ``flash_attention`` (kernel 5 and the fused backward; out within 2e-5, gradients within 1e-4 of their largest |value|), the
   forward against the scan arm on the card; a non-causal ring at sp=4 (16
   launches) and ``ulysses_attention`` at sp=4 against the same reference.
   Forward and forward+backward times, tokens/s and TFLOP/s of the ring,
   the un-sharded kernels and SDPA's memory-efficient backend (yardstick),
   and one profiled ring forward+backward by kernel group (the merge's
   share).
12. compositions at gpt2-small's width on meshes of 4 entries of cuda:0,
   each against its un-sharded form within 1e-4 of the largest |value|:
   ``tensor_parallel.mlp_block`` (768 -> 3072 -> 768, tp=4, 8,192 tokens),
   ``moe_transformer_ffn`` (8 experts of 768 -> 3072, k=2, capacity factor
   1.25, ep=4, 8,192 tokens; against the no-mesh layer on each shard's
   2,048 tokens, whose capacity is the shard's), ``pipeline_transformer``
   (4 gpt2-small blocks, pp=4, batch 8 x 1024, 4 microbatches; against the
   blocks in sequence), with times.

2f. rtc kernels (run after 2e): kernel 11, ``rtc.CudaModule``, compiles
   user CUDA C with NVRTC (the reference's three test bodies — add-one,
   a row scale over a grid of 4, a missing export that must raise — an
   axpy and a bf16 template scale); each user kernel is launched once with
   the counters zeroed just before and read just after, and held against
   its PyTorch expression, fp32 to the bit, bf16 within one ulp; the
   compile's seconds, and axpy's time at n = 2^26 beside its bound, the
   plain expression and ``y.add_(x, alpha=a)`` (the yardstick).
13. the Module path: bench.py's ``_multichip_run`` on one context,
   ``resnet50_v1()`` on ``sym.var("data")`` then ``SoftmaxOutput``, batch
   32, 224 px, 1,000 classes, fp32, ``Module(context=gpu(0))``,
   ``Xavier(gaussian, 2)`` after ``random.seed(7)``, SGD lr 0.1 momentum
   0.9 through ``kvstore='local'``, the batch from ``RandomState(3)``.  The
   first fused step, with the counters zeroed just before it and read
   after the last timed step (32 kernel-1 launches, 16 and 16 of kernel
   2's passes a step, as phase 5), against the eager path
   (``MXNET_TPU_FUSED_STEP=0``) and against the CPU: probabilities within
   1e-4, each update within 1% of its norm and 5% for the 3x3 weights,
   ``fc1``'s update non-zero; 2 warm-up and 10 timed steps give train
   images/s, and two profiled steps the device time by group (as phase 6)
   and the idle share.  Then ``fit`` for one epoch of 4 batches of an
   ``NDArrayIter`` of 128 seeded images in a ``PrefetchingIter`` (acc and
   ce, ``Speedometer``, ``do_checkpoint``), ``Module.load`` with the
   optimizer states, ``score`` equal to the trained module's, and
   ``predict`` of (128, 1000) rows summing to 1.

2g. bf16 conv kernels (run after 2f): kernel 12 (``conv1x1_wgrad.cu``, the
   1x1 weight gradient of ``tools/probe_conv_fixes.py:173``) against
   ``conv1x1_wgrad_plain`` on the same bf16 card tensors at the 15 1x1
   shapes of a batch-128 ResNet-50 v1 step, at the probe's (401,408 x 64)
   x (401,408 x 256) and at ten ragged shapes (rows off the tile, C = 8,
   odd spatial dims at stride 2, an empty split closing a cluster, each of
   its six tiles), each also with x at storage offset 1 (its element path,
   also at 56x56 C 256 O 128 stride 2, batch 128), within 1e-4 of the
   largest |dw| (fp32 sums in another order; bf16 products are exact in
   fp32), every call twice, bit-equal, launching the partial pass once and
   the reduction pass once when its plan (``conv1x1_wgrad_plan``) leaves
   more than one partial; its blocks an SM, read on the card, at least the
   plan's one; its sum over a batch-128 step beside cuDNN's; kernels 1 and
   2's bf16 kernels on the tensor cores (``taps_conv_bf16.cu``, forward
   and dgrad, against ``taps_conv_plain``: both round one fp32 sum to
   bf16, rtol 2^-7, atol 1e-4 of the largest |value|; ``taps_wgrad_bf16.cu``
   against ``taps_wgrad_plain``, 1e-4 of the largest |dw|) at ragged
   shapes (N 3 7x9 C 24 O 40; N 2 5x5 C 3 O 8; N 5 33x31 C 24 O 40, rows
   off the stage and the tile), the stride-2 class at stride 2 (N 2
   10x10 C 8 O 16 through ``conv3x3_s2``, N 3 14x10 C 24 O 48; kernel 2 at
   2x2 taps) and an ``x``
   at storage offset 1 (the element path; kernel 1 also at 28x28 with 128
   channels at batch 128, at both of its tiles), each call launching the
   bf16 kernel once, kernel 2 twice on the same inputs with bit-equal
   results; their blocks an SM holds against the host plans'; then at the
   4 Gluon 3x3 shapes at batch 128, kernel 1's forward at both of its
   tiles.  Each with its time, TFLOP/s and bound (bf16 tensor-core peak,
   or bytes over 3.35 TB/s where larger) beside the plain version's and
   cuDNN's bf16 yardstick (``conv2d_weight`` / ``conv2d_input`` /
   ``F.conv2d``, never called by the port on these shapes); each kernel's
   sum over a step must be under the fp32 CUDA-core ceiling (its FLOPs over
   67 TFLOP/s).
14. bf16 training: bench.py ``main()`` on its accelerator, Gluon
   ``resnet50_v1`` (224 px, 1,000 classes) trained by
   ``FusedTrainer(..., dtype="bfloat16")`` (SGD lr 0.1, momentum 0.9) at
   batch 128 on gpu(0).  The counters, zeroed before the first step and
   read after the last timed one, must read a step 32 launches of kernel
   1's bf16 kernel, 16 of kernel 2's bf16 partial pass with the bf16
   plan's reductions (16 on 132 SMs), none of their fp32 kernels, and 36
   of kernel 12's partial pass with its plan's reductions (35 on 132 SMs);
   the profile reads the
   same bf16 launches from the trace; the masters stay fp32, the loss
   finite and falling; 2 warm-up and
   10 timed steps give bf16 train images/s, printed beside phase 5's fp32;
   two profiled steps the device time by group and the idle share, and
   one step the NHWC copies that the 1x1s' and the 3x3s' backwards make.
   The first step at batch 8 (4 if the CPU step takes over 60 s) against
   the CPU from the same fp32 weights: the loss, every trained parameter's
   update and the whole update (by norm) each within max(2 x its own bf16
   band, 2^-7), the band being its distance between the card's bf16 and
   fp32 steps, measured in the phase.
15. bf16 Module: bench.py ``--bf16`` (``bench_bf16``): ``resnet50_v1`` ->
   ``SoftmaxOutput`` through ``Module(context=[gpu(0)])`` at batch 128,
   fp32 and then under ``MXNET_TPU_BF16=1`` with multi-precision SGD (lr
   0.01, momentum 0.9), 30 steps each on ``RandomState(3)``'s batch:
   bench.py's convergence band, parameter bytes plus the step's peak
   activation bytes at bf16 <= 0.65x fp32's, bf16 weights and fp32
   masters under the flag, fp32 without; kernels 1 and 2's launches over
   each run's 42 steps (bf16: 32 of the bf16 conv kernel, 16 of the bf16
   wgrad and its plan's reductions a step, no fp32 ones; fp32 the reverse,
   at the fp32 kernel's splits); images/s of both; one bf16 step fused and
   one eager with bit-equal masters and weights.

2h. fused bottleneck kernel (run after 2g): kernel 13
   (``fused_bottleneck.cu``, the identity bottleneck of
   ``tools/probe_fused_block.py:74`` with BatchNorm folded) against
   ``fused_bottleneck_plain`` on the same bf16 card tensors at ResNet-50
   v1's 4 identity-bottleneck shapes at batch 128 (56x56/256/64,
   28x28/512/128, 14x14/1024/256, 7x7/2048/512), the probe's own (N 32,
   28x28, 512/128) and two ragged ones (N 1 at 9x11; a narrow 128/32 block
   at 15x17), and each arm of its plan (``hopper_block.
   fused_bottleneck_plan``: warps along a chunk's rows, band rows, ring
   depth, h2 over h1 or apart) forced at N 3, 9x11, 128/64: within one
   bf16 step (rtol 2^-7) plus 1e-3 of the largest |out|, every call twice
   and bit-equal, one launch a call; the card's shared memory a block
   against the plan's limit and one block an SM at each plan's layout.
   Each with its time beside the time before its redesign (quoted) and
   the plain version's, the bound (bytes over 3.35 TB/s or FLOPs over 989
   TFLOP/s) and the unfused cuDNN bf16
   sequence on the same folded weights (three channels-last ``F.conv2d``
   with bias, ReLU and the residual as elementwise ops; the yardstick
   only).
2i. FCN-8s's 3x3 shapes (run after 2h): kernel 1 (forward, and dgrad
   with flipped, io-swapped taps) and kernel 2 (wgrad) in fp32 against
   their plain versions at the 8 distinct stride-1 3x3 shapes of FCN-8s
   on VGG-16 at batch 1 and 500 px (C = O = 64 at 698 x 698, 64->128 and
   128 at 349, 128->256 and 256 at 174, 256->512 and 512 at 87, 512 at
   43), with the tolerances of phases 2 and 2b, each call twice,
   bit-equal, launching what its plan says; each timed beside its plain
   version, cuDNN (the yardstick only) and the bound, and summed over one
   FCN-8s step's 12 forwards, 12 dgrads and 12 wgrads.
16. bf16 inference: phase 15's bf16 Module after its steps, the eval pass
   of a bf16 run: ``predict`` over an ``NDArrayIter`` of 2 batches of 128
   from ``RandomState(3)`` and ``score`` with ``Accuracy``, the counters
   zeroed just before and read just after: 12 kernel-13 and 4 launches of
   kernel 1's bf16 kernel a forward, none of its fp32 kernel or of kernels
   2 or 12 (the profile reads the same from the trace).  The same weights and
   moving statistics in an fp32 Module bound for inference measure the
   bf16 band of the logits (norm of the difference over the fp32 norm) and
   the share of equal top-1; the CPU's bf16 logits at batch 8 (plain arms)
   must lie within twice that band of the card's.  bf16 and fp32 inference
   images/s (median of 10 forwards after 2 warm-ups), none of them folding
   (the folded weights are cached), a profile of the bf16 forward by group
   with its idle share, and the folding's one-off time after a weight
   change.

17. bucketing: ``example/rnn/bucketing/lstm_bucketing.py``'s model at the
   LM's width (vocab 33,278, embed = hidden = 650, 2 layers, batch 128,
   fp32, no dropout; 50.06 M parameters) through ``mod.BucketingModule``
   and ``rnn.BucketSentenceIter`` (buckets 10, 20, 30, 40, the example's
   synthetic corpus of 2,200 sentences at that vocabulary), the example's
   ``Mixed``/``FusedRNN`` initializer after ``random.seed(0)``, Adam lr
   0.001 (the example's 0.01 diverges at this vocabulary),
   ``Perplexity(ignore_label=0)``: one ``fit`` epoch and a
   ``score``.  The counters, zeroed just before each and read just after,
   must read 2 launches of kernel 8 and 2 of kernel 9 a training batch
   (one per layer) and 2 of kernel 8 a scored one; the four buckets'
   parameters are one set of tensors (same ``data_ptr``); the last three
   batches' loss (SoftmaxOutput's cross-entropy, pads included) is below
   the first batch's, and the score's perplexity below the first batch's;
   the first T-10 batch's loss (rtol 1e-4) and Adam updates (1% of their
   norm) match the CPU's (plain versions) from the same weights, Adam
   states and batch.  Step ms and train tokens/s per bucket, the host time
   of a bucket switch and of each bucket's first bind, and a two-step
   profile of a T-40 batch by group with its idle share.

18. ImageRecordIter: ``example/image-classification/train_imagenet.py``'s
   data path.  The phase writes 1,024 synthetic JPEGs (smooth random fields
   with a few shapes; short side 256, long side 256-384, quality 95, as
   im2rec's ``--resize 256`` writes them; labels below 1,000 from a seed)
   with the port's ``MXIndexedRecordIO`` and ``pack_img``, then reads them
   through ``io.ImageRecordIter`` (data shape 3 x 224 x 224, batch 32,
   shuffle, random crop and mirror, ImageNet's mean and std, batches on
   gpu(0)): the iterator alone for one epoch at the default decode
   threads and at the host's core count (images/s, the decoder); the
   labels those written in the shuffled order; the first batch at one
   thread on gpu(0) bit for bit the ``cpu()`` one; a JPEG round trip of a
   smooth image above 40 dB PSNR.  Then phase 13's ResNet-50 v1 through
   ``Module.fit`` for one epoch of 32 batches from the iterator (SGD lr
   0.1, momentum 0.9, wd 1e-4, accuracy): images/s over batches 3-32
   beside phase 13's, the share of ``fit`` spent waiting in ``next()``,
   the batch's copy to the card (CUDA events in the producer; and alone,
   pageable and pinned), every batch's loss finite, and kernels 1 and 2's
   launches over the epoch, zeroed just before ``fit`` and read just
   after: 32 times a step's.  ``close()`` leaves no decode or producer
   thread.  The same fit at one decode thread and with OpenCV's worker
   threads off (``cv2.setNumThreads(1)``, restored after), and each
   stage's host ms on one thread (read, decode, augment, transpose,
   place), show what sets the pace.

19. eager: imperative training, ``autograd.record`` / ``backward`` /
   ``gluon.Trainer.step``.  First ``group2ctx``: the reference's two-group
   MLP (``AttrScope(ctx_group=)``) bound on cpu(0) with ``dev1`` on cpu(0)
   and ``dev2`` on gpu(0): its output on the card, its forward and
   backward within 1e-6 of the ungrouped gpu(0) executor's.  Then phase
   5's ResNet-50 v1 (the same seeded weights and batch, fp32, batch 32,
   224 px) trained by ``Trainer("sgd", lr 0.1, momentum 0.9)`` with the
   net hybridized: its first step against ``FusedTrainer``'s first step
   on the card from the same state (the mean loss within rtol 1e-4, each
   of the 16 3x3 weight updates within 5% of its norm); a third copy not
   hybridized (every op through ``nd``, recorded): its first two losses
   within 1e-5 of the hybridized arm's, then 10 timed steps.  Kernels 1 and 2's
   counters, zeroed just before each arm and read just after, must read a
   step the fused step's launches (32 + its plan's split sums of kernel
   1, 16 + 16 of kernel 2).  Then bench.py's LM (phase 7's, dropout 0.2)
   trained by ``Trainer("sgd", lr 0.5)``, hybridized: kernels 8 and 9
   launched twice a step each, its first step against ``FusedTrainer``'s
   from the same state and the same dropout generator (``random.seed``
   before each; the loss within rtol 1e-5, each update within 1e-3 of its
   norm).  20 timed steps of each (images/s and tokens/s printed beside
   phases 5 and 7's), and a profile of each eager step: device busy
   share, launches a step and the Trainer update's share; the host ms to
   queue each part of a step (forward and loss, backward,
   ``Trainer.step``) beside ``FusedTrainer``'s, ResNet-50's median step
   with Python's garbage collector off, and each model's eager step
   against ``FusedTrainer``'s timed in turns on the card (fused, eager,
   eager, fused; 10 steps each).

20. the rest of the op layer: every deterministic op of it
   (``_linspace``, ``_eye``, ``ops/misc_parity.py``'s, ``Deconvolution``
   (FCN's 16 x 16 stride 8, and ``target_shape`` with groups), ``Crop``,
   ``UpSampling`` nearest and bilinear, ``LeakyReLU``'s six kinds,
   ``InstanceNorm``, ``L2Normalization``'s three modes, ``LRN``,
   ``SoftmaxActivation``, the three regression outputs, ``Pooling(
   pool_type='lp')``) once on gpu(0) against the port's own CPU result,
   outputs and the gradients of a seeded weighted sum, within 1e-5 (1e-4
   where a value sums many products) of max(1, |cpu|); then each sampler
   of ``nd.random`` and each ``_sample_*`` op at 10^6 draws on the card:
   mean within 6 standard errors and variance within 2% of the
   distribution's, one seed giving the same draws twice, multinomial's
   frequencies and ``get_prob``'s log(p[draw]), shuffle a seeded
   permutation.
21. FCN-8s on VGG-16 at full width (Long, Shelhamer and Darrell, CVPR
   2015, as upstream MXNet's ``example/fcn-xs/symbol_fcnxs.py``: 21
   classes, conv1_1 padded by 100, fc6 7 x 7 and fc7 1 x 1 convolutions
   of 4,096 with Dropout 0.5, scores from fc7, pool4 and pool3, two 4 x 4
   stride-2 and one 16 x 16 stride-8 ``Deconvolution``, ``Crop`` at (5,
   5), (9, 9), (31, 31), ``SoftmaxOutput(multi_output, use_ignore,
   ignore_label=255, normalization='valid')``).  First, at 1 x 3 x 192 x
   192 and full width, dropout off, the first step through ``Module``'s
   eager arm on the card against the port on the CPU from the same
   weights: the loss within rtol 1e-4, the gradients of conv1_2,
   conv5_3, fc6 and the 16 x 16 deconvolution within 1e-3 in norm.
   Then ``Module.init_params`` with ``init.Mixed`` (``Bilinear`` for the
   deconvolutions, ``Xavier`` for the rest) and ``fit`` over an
   ``NDArrayIter`` of 8 synthetic 1 x 3 x 500 x 500 images (rectangles of
   the 20 object classes on noise, a band of 255 labels) for 3 epochs,
   SGD lr 0.001, momentum 0.9, wd 5e-4: kernels 1 and 2's launches
   counted each step and held to those the plans give (12 forwards and 12
   dgrads of kernel 1, 12 wgrads of kernel 2, and their split sums), the
   loss finite and its last epoch's mean below its first's; ``score``
   with pixel accuracy and ``predict`` (finite probabilities summing to
   1); step ms, images/s, the device's busy share, its time by group and
   its top operations.
2j. (run after 2i) kernels 1 and 2 fp32 at DenseNet-121's 3x3 shapes,
   batch 32, 3x3 / pad 1 at 56, 28, 14 and 7 px: the forward C 128 to O
   32 (half of the narrowest 64-column tile, so every launch has a ragged
   column edge), the data gradient C 32 to O 128, the weight gradient taps
   (9, 128, 32); each against ``taps_conv_plain`` / ``taps_wgrad_plain``
   (rtol = atol = 1e-4; 1e-4 of the largest |dw|), run twice, bit-equal,
   with the plan's launches; each tile of kernel 1 forced at one split and
   at the plan's splits, checked and timed beside the plan's pick; the 14
   px shape again with an operand at storage offset 1 (the element load
   paths); kernel and plain times on operands already in the kernels'
   layout, the wrappers' with their layout rewrites, cuDNN's ``conv2d``,
   ``conv2d_input`` and ``conv2d_weight`` (TF32 off; the yardstick only),
   TFLOP/s and the bound at 67 TFLOP/s (CUDA events, 20 calls after 3
   warm-ups), and the sums over one DenseNet-121 step (58 of each).
22. DenseNet-121 (Huang et al., 2017; the zoo's ``densenet121``, 1000
   classes) at full width, hybridized, fp32, batch 32 x 3 x 224 x 224,
   ``init.Xavier``, trained by ``autograd.record`` and ``gluon.Trainer(
   "nag", lr 0.0125, momentum 0.9, wd 1e-4)``: the paper's Nesterov SGD
   (lr 0.1 at batch 256) scaled to batch 32.  First, at batch 2 and full
   depth, the first step on the card against the port on the CPU from the
   same weights (``save_parameters`` on the CPU, ``load_parameters`` onto
   the card): the mean loss within rtol 1e-4, each of the 121 weights'
   updates within 5% of its norm.  The data: phase 18's writer makes a
   ``.rec`` of 1,024 synthetic JPEGs (no ImageNet in the repository),
   read by ``gluon.data.DataLoader(ImageRecordDataset(rec).transform_first(
   Compose([RandomResizedCrop(224), RandomFlipLeftRight(), ToTensor(),
   Normalize(mean, std)])), batch_size=32, shuffle=True, num_workers=4,
   last_batch="discard")``; its first batch (the iterator then dropped,
   leaving no worker thread) on the card for 1 + 2 warm-up + 10 timed
   steps (images/s from the median), then one epoch through the loader
   (32 steps: images/s, the share waiting in ``next()``, a step with and
   without the loader).  Kernels 1 and 2's counters, zeroed just before
   and read each step, hold every step to the plans (58 forwards and 58
   dgrads of kernel 1, 58 wgrads of kernel 2, with their split sums); the
   7x7 stem and the 1x1s stay on cuDNN.  A profile of two steps (busy and
   idle share, device ms by group, launches a step, the top operations),
   peak memory, every loss finite.  Then 5 epochs of a 64-image subset
   (centred crops): the epoch mean losses fall.  Last, the trained net's
   logits on 2 images against a fresh ``densenet121`` after
   ``load_parameters`` of its ``save_parameters`` on the CPU and on the
   card, and against ``SymbolBlock.imports`` of its ``export`` on the
   card: each within 1e-5 of the largest |logit|.
23. the model zoo through ``example/image-classification/
   benchmark_score.py``'s ``score()`` on the port (hybridized inference
   on a uniform batch, 3 warm-ups, 10 timed forwards): its default
   networks (``resnet18_v1``, ``resnet50_v1``, ``mobilenet1_0``,
   ``squeezenet1_0``) at batch 1 and 32, then ``resnet50_v2``,
   ``vgg16_bn``, ``alexnet``, ``densenet121``, ``inception_v3`` (299 px)
   and ``mobilenet_v2_1_0`` at batch 32, each with seeded MSRA-scaled
   weights: images/s; the batch-1 logits against the port on the CPU from
   the same weights (``save_parameters``/``load_parameters``) within 1e-4
   of the largest |logit|, the same top-1; kernel 1's launches over one
   forward at each batch equal to the net's 3x3 / pad-1 convolutions that
   the dispatch routes to it (stride 1, or 2 on even sides; one group:
   MobileNet's depthwise 3x3s stay on cuDNN), with their plans' split
   sums, and above 0 on resnet18_v1, squeezenet1_0, vgg16_bn, densenet121
   and inception_v3.

It then prints the ``kernels`` JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` as the last line.  TF32 is off for
cuDNN and for matmuls throughout, so every fp32 comparison is fp32 against
fp32.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))

KERNEL_TOL = 1e-4      # rtol = atol, kernel vs plain (fp32 FMA vs fp32 GEMM)
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core FLOP/s
BF16_BATCH = 128       # bench.py main()'s accelerator batch (bench.py:840)
# ResNet-50 v1's 1x1 convolutions (the Gluon v1 block strides its first
# 1x1): (C, O, output H = W, stride, instances a training step); 36 in all
RESNET50_1X1 = [(64, 64, 56, 1, 1), (64, 256, 56, 1, 4), (256, 64, 56, 1, 2),
                (256, 128, 28, 2, 1), (256, 512, 28, 2, 1),
                (128, 512, 28, 1, 4), (512, 128, 28, 1, 3),
                (512, 256, 14, 2, 1), (512, 1024, 14, 2, 1),
                (256, 1024, 14, 1, 6), (1024, 256, 14, 1, 5),
                (1024, 512, 7, 2, 1), (1024, 2048, 7, 2, 1),
                (512, 2048, 7, 1, 3), (2048, 512, 7, 1, 2)]
W1X1_TOL = 1e-4        # max |dw_kernel - dw_plain| / max |dw_plain| (fp32
                       # sums in another order; the bf16 products are exact)
# kernel 1 in bf16 against its plain version: both round an fp32 sum to
# bf16 once, so they differ by at most one bf16 step of the value (2^-7
# relative) plus the fp32 order difference (1e-4 of the largest |value|)
BF16_RTOL = 2.0 ** -7
BF16_ATOL_REL = 1e-4
PROB_TOL = 1e-4        # max |p_gpu - p_cpu| of served probabilities
PEAK_FP32 = 67e12      # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12    # H100 SXM device memory bytes/s
BATCH = 32
SEED = 0

# the 3x3 convolutions of one ResNet-50 forward: (class, C = O, input H = W,
# instances per forward)
RESNET50_3X3 = [("s1", 64, 56, 3), ("s1", 128, 28, 3), ("s1", 256, 14, 5),
                ("s1", 512, 7, 2), ("s2", 128, 56, 1), ("s2", 256, 28, 1),
                ("s2", 512, 14, 1)]
# the 3x3 convolutions of a Gluon ResNet-50 v1 (stride on the 1x1, so all
# stride 1): (C = O, H = W, instances per step)
GLUON_3X3 = [(64, 56, 3), (128, 28, 4), (256, 14, 6), (512, 7, 3)]
# ragged bf16 shapes for the tensor-core kernels, (N, H, W, C, O): channels
# off the 8-channel copy and the 64-channel tile, C = 3, rows off the
# 32-row wgrad stage and the 128-row conv tile; the last (5,115 rows) splits
# the wgrad rows with a ragged last split
RAGGED_BF16 = [(3, 7, 9, 24, 40), (2, 5, 5, 3, 8), (5, 33, 31, 24, 40)]
WGRAD_TOL = 1e-4       # max |dw_kernel - dw_plain| / max |dw_plain|
# first training step on the card vs the CPU: the loss, and each 3x3
# weight's update in Frobenius norm (the one-step gradient of a 53-layer
# BatchNorm net is ill-conditioned in fp32: tests/test_torch_train.py)
LOSS_RTOL = 1e-4
UPDATE_TOL = 0.05
WARMUP_STEPS = 2
TIMED_STEPS = 10


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fp32_exact():
    """cuDNN convolutions and matmuls in full fp32 (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _bound(flops, nbytes, peak=PEAK_FP32):
    ops_s, bytes_s = flops / peak, nbytes / HBM_BYTES
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_steps(step, on_result=None, timed=TIMED_STEPS):
    """Host-clock seconds of ``timed`` calls of ``step`` after
    ``WARMUP_STEPS``, each call between two ``torch.cuda.synchronize()``;
    ``on_result`` gets every call's result, after its time is taken."""
    times = []
    for i in range(WARMUP_STEPS + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            times.append(time.perf_counter() - t0)
        if on_result is not None:
            on_result(out)
    return times


PROFILE_TAKES = 3      # traces taken before a lossy one fails the phase
# A trace loses the device records of its first kernels (the launch calls
# kept): a few, more as the process ages, and now and then every one of
# its first milliseconds (tools/probe_profiler_loss.py).  So each trace
# opens with PROFILE_FILLERS spin kernels, then PROFILE_PAD_S seconds with
# the device idle, before the traced calls.
PROFILE_FILLERS = 256
PROFILE_PAD_S = 0.05


def _trace_losses(events, skip=0):
    """(kernel launch calls in a trace after its first ``skip``, those of
    them whose kernel has no device record).  A launch call
    (``cudaLaunchKernel``, ``cuLaunchKernel`` and their ``Ex`` forms) and
    the kernel it launched share their CUPTI correlation id."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    recorded = {e.id for e in events if e.device_type == cuda}
    calls = sorted((e for e in events
                    if e.device_type == cpu and "LaunchKernel" in e.name),
                   key=lambda e: e.time_range.start)[skip:]
    return len(calls), sum(1 for e in calls if e.id not in recorded)


def _profile_take(step, n, fillers=PROFILE_FILLERS, pad_s=PROFILE_PAD_S):
    """The events of one trace of ``fillers`` spin kernels, ``pad_s``
    seconds idle, then ``n`` calls of ``step``; and the wall ms a call of
    ``step``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(fillers):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(pad_s)
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    return prof.events(), wall_ms


def profiled_kernels(step, n, tag="profile"):
    """The device's kernels, in start order, of ``n`` calls of ``step``
    under torch.profiler (the fillers left out), and the profiled wall ms
    a call.  A trace that lost the record of a kernel that ``step``
    launched is taken again (``n`` more calls of ``step``), at most
    ``PROFILE_TAKES`` times in all; the phase fails if every take lost
    one."""
    for take in range(1, PROFILE_TAKES + 1):
        events, wall_ms = _profile_take(step, n)
        calls, lost = _trace_losses(events, PROFILE_FILLERS)
        if lost == 0:
            break
        print("[%s] trace %d of at most %d lost the device records of %d of "
              "its %d kernel launch calls" % (tag, take, PROFILE_TAKES, lost,
                                              calls))
    check(lost == 0, "every one of %d traces lost kernel records"
          % PROFILE_TAKES)
    check(calls > 0, "the trace holds no kernel launch call")
    return sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.name),
                  key=lambda e: e.time_range.start), wall_ms


# --------------------------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    info = _build.build()
    print("[build] %d source(s) in %.2f s" % (len(info),
                                             time.perf_counter() - t0))
    for name, rec in info.items():
        print("[build] %s: %.2f s, built=%s" % (name, rec["seconds"],
                                                rec["built"]))
        for line in rec["log"].splitlines():
            if "registers" in line or "stack frame" in line \
                    or "spill" in line:
                print("[build]   " + line.strip())
    return info


# kernel 1 fp32's times in the last run of this script before its redesign
# ("NVIDIA H100 80GB HBM3, 700.00 W"), ms a call at batch 32: the
# served forward's 7 shapes and the Gluon dgrad's 4 (by C = O); the record
# printed beside this run's times
BEFORE_K1_MS = {("s1", 64, 56): 0.3052, ("s1", 128, 28): 0.3184,
              ("s1", 256, 14): 0.4047, ("s1", 512, 7): 0.4758,
              ("s2", 128, 56): 0.7376, ("s2", 256, 28): 0.7681,
              ("s2", 512, 14): 1.0056}
BEFORE_DGRAD_MS = {64: 0.3099, 128: 0.3125, 256: 0.4070, 512: 0.4839}
# kernel 1 fp32 at ragged and misaligned shapes, (N, H, W, C, O, stride):
# channels off the 4-channel copy and the tiles, C = 3, odd maps at stride 2
RAGGED_FP32_CONV = [(3, 7, 9, 20, 70, 1), (1, 1, 1, 3, 5, 1),
                    (5, 12, 10, 33, 129, 2), (2, 14, 14, 256, 256, 2),
                    (3, 9, 11, 24, 40, 2)]


def _conv_fp32_occupancy_checks(hc, dev):
    """The blocks an SM holds of kernel 1 fp32 at each tile and load path,
    read on the card, against what its plan assumes."""
    import ctypes
    from mxnet_tpu_torch import _build
    lib = _build.load("implicit_gemm_conv")
    n = ctypes.c_int()
    got = {}
    for bm, bn, per_sm, _ in hc._CONV_FP32_TILES:
        for vec in (0, 1):
            check(lib.mxtt_taps_conv_occupancy(bm, bn, vec, dev.index,
                                               ctypes.byref(n)) == 0,
                  "occupancy query of implicit_gemm_conv failed")
            got["%dx%d vec %d" % (bm, bn, vec)] = (n.value, per_sm)
    print("[kernels] kernel 1 (fp32) blocks an SM holds (card, plan): %s"
          % got)
    check(all(card == plan for card, plan in got.values()),
          "kernel 1 (fp32)'s occupancy differs from its plan's: %s" % got)
    return {k: v[0] for k, v in got.items()}


def _conv_fp32_call(hc, x, taps, stride, plan, label):
    """Kernel 1 fp32 at ``plan`` (None: the shape's own) against
    ``taps_conv_plain`` on the same card tensors, run twice: within
    KERNEL_TOL, bit-equal, each call one launch of the convolution and one of
    its split sum when the plan splits.  Returns (result, plan, max abs
    error)."""
    N, H, W, C = x.shape
    O = taps.shape[2]
    Ho, Wo = hc._out_hw(H, W, 3, 3, hc.S1_PADS, stride)
    want = hc.taps_conv_plain(x, taps, hc.S1_PADS, 3, 3, stride)
    if plan is None:
        plan = hc.conv_fp32_plan(N * Ho * Wo, C, O, 3, 3, _sms(x.device),
                                 (x.data_ptr(), taps.data_ptr(), 0))
    before = (hc.launches, hc.conv_reduce_launches)
    got = hc._taps_conv_cuda(x, taps, hc.S1_PADS, 3, 3, stride, plan=plan)
    again = hc._taps_conv_cuda(x, taps, hc.S1_PADS, 3, 3, stride, plan=plan)
    torch.cuda.synchronize()
    launched = (hc.launches - before[0], hc.conv_reduce_launches - before[1])
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL),
          "kernel 1 (fp32) disagrees with its plain version at %s, tile %s, "
          "%d splits: max abs err %g" % (label, plan.tile, plan.splits, err))
    check(torch.equal(got, again), "kernel 1 (fp32) gave other bits on the "
          "same inputs at %s, tile %s, %d splits" % (label, plan.tile,
                                                     plan.splits))
    check(launched == (2, 2 * (plan.splits > 1)), "kernel 1 (fp32) at %s "
          "launched %s (convolution, split sum) in two calls, the plan %s"
          % (label, launched, plan))
    return got, plan, err


def _ragged_conv_fp32_checks(hc, dev, gen):
    """Kernel 1 fp32 at ragged shapes and stride 2 natively, each also with
    x at storage offset 1 (4 bytes off a 16-byte boundary: the 4-byte copy
    path), bit-equal on reruns."""
    errs = {}
    for N, H, W, C, O, stride in RAGGED_FP32_CONV:
        x = torch.randn(N, H, W, C, device=dev, generator=gen)
        taps = torch.randn(9, C, O, device=dev, generator=gen) * 0.1
        for xx in (x, _at_offset_1(x)):
            label = "N=%d %dx%d C=%d O=%d s%d%s" % (
                N, H, W, C, O, stride, " offset 1" * (xx is not x))
            _, plan, err = _conv_fp32_call(hc, xx, taps, stride, None, label)
            check(plan.vec == (xx is x and C % 4 == 0 and O % 4 == 0),
                  "kernel 1 (fp32) at %s took the %s path" % (
                      label, "16-byte" if plan.vec else "4-byte"))
            errs[label] = err
    print("[kernels] ragged and misaligned shapes: kernel 1 (fp32) matches "
          "its plain version, bit-equal on reruns: %s"
          % ", ".join("%s %.3g" % kv for kv in errs.items()))
    return errs


def _s2_single_launch_check(hc, x, w, plan):
    """One ``conv3x3_s2`` call under torch.profiler: the convolution kernel
    once and the plan's split sum, and no copy of the input (the weight's
    layout copy to taps is the only other kernel)."""
    kernels, _ = profiled_kernels(lambda: hc.conv3x3_s2(x, w), 1)
    names = [e.name for e in kernels]
    convs = [n for n in names if "taps_conv_kernel" in n]
    sums = [n for n in names if "split_sum_kernel" in n]
    others = [n for n in names if n not in convs and n not in sums]
    check(len(convs) == 1 and len(sums) == int(plan.splits > 1)
          and len(others) <= 1, "a stride-2 call ran %s" % names)
    return {"kernels": len(names), "others": others}


def phase_kernels():
    """Kernel 1 fp32 vs plain at the 7 ResNet-50 3x3 shapes (stride 2
    natively), each of its tiles and splits, ragged and misaligned shapes;
    returns the ``kernels`` entry (without ``launches``)."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    occupancy = _conv_fp32_occupancy_checks(hc, dev)
    ragged = _ragged_conv_fp32_checks(hc, dev, gen)
    shapes = []
    for kind, C, H, count in RESNET50_3X3:
        O = C
        stride = 1 if kind == "s1" else 2
        fn, plain = ((hc.conv3x3_same, hc.conv3x3_same_plain) if kind == "s1"
                     else (hc.conv3x3_s2, hc.conv3x3_s2_plain))
        # channels-last, as the kernel's own outputs reach the next conv
        x = torch.randn(BATCH, C, H, H, device=dev, generator=gen) \
            .contiguous(memory_format=torch.channels_last)
        w = torch.randn(O, C, 3, 3, device=dev, generator=gen) \
            / math.sqrt(9 * C)
        xh, taps = hc._nhwc(x), hc._s1_taps(w, torch.float32)
        Ho = H // stride
        M = BATCH * Ho * Ho
        _, plan, _ = _conv_fp32_call(hc, xh, taps, stride, None,
                                     "%s C=%d %d px" % (kind, C, H))
        y = fn(x, w)
        yp = plain(x, w)
        yl = F.conv2d(x, w, stride=stride, padding=1)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        rel = err / yp.abs().max().item()
        err_lib = (y - yl).abs().max().item()
        ok = torch.allclose(y, yp, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        # every tile at 1 split, the plan's split and 2, each checked
        variants = {}
        ks = 9 * hc._cdiv(C, hc._CONV_FP32_BK)
        for bm, bn, _, _ in hc._CONV_FP32_TILES:
            for splits in sorted({1, 2, plan.splits}):
                if hc._cdiv(ks, hc._cdiv(ks, splits)) != splits:
                    continue
                vp = hc.conv_fp32_plan(M, C, O, 3, 3, _sms(dev), (16, 16, 16),
                                       tile=(bm, bn), splits=splits)
                _conv_fp32_call(hc, xh, taps, stride, vp,
                                "%s C=%d %d px" % (kind, C, H))
                variants["%dx%d/%d" % (bm, bn, splits)] = time_ms(
                    lambda: hc._taps_conv_cuda(xh, taps, hc.S1_PADS, 3, 3,
                                               stride, plan=vp))
        ms = time_ms(lambda: fn(x, w))
        plain_ms = time_ms(lambda: plain(x, w))
        lib_ms = time_ms(lambda: F.conv2d(x, w, stride=stride, padding=1))
        flops = 2.0 * BATCH * Ho * Ho * O * C * 9
        bound_ms, bound_by = _bound(
            flops, 4.0 * (x.numel() + w.numel() + BATCH * O * Ho * Ho))
        rec = {"class": kind, "N": BATCH, "C": C, "O": O, "H": H, "W": H,
               "Ho": Ho, "instances_per_forward": count,
               "tile": list(plan.tile), "splits": plan.splits,
               "blocks_per_sm": occupancy["%dx%d vec 1" % plan.tile],
               "bit_equal_rerun": True, "variants_ms": variants,
               "max_abs_err": err, "max_rel_err": rel,
               "max_abs_err_vs_cudnn": err_lib, "tol": KERNEL_TOL,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gflop": flops / 1e9, "tflops": flops / ms / 1e9}
        if kind == "s2":
            rec["profile"] = _s2_single_launch_check(hc, x, w, plan)
        shapes.append(rec)
        print("[kernels] %s C=O=%d %dx%d->%dx%d N=%d (tile %dx%d, %d splits; "
              "rerun bit-equal): max_abs_err %.3g (rel %.3g, tol %g) vs cuDNN "
              "fp32 %.3g | kernel %.4f ms (%.1f TFLOP/s; before %.4f), plain "
              "%.4f ms, cuDNN %.4f ms, bound %.4f ms (%s)"
              % (kind, C, H, H, Ho, Ho, BATCH, plan.tile[0], plan.tile[1],
                 plan.splits, err, rel, KERNEL_TOL, err_lib, ms,
                 rec["tflops"], BEFORE_K1_MS[(kind, C, H)], plain_ms, lib_ms,
                 rec["bound_ms"], rec["bound_by"]))
        print("[kernels]   tiles/splits ms: %s%s" % (
            ", ".join("%s %.4f" % kv for kv in variants.items()),
            "; a stride-2 call ran %d kernels (other than kernel 1 and its "
            "split sum: %s)" % (rec["profile"]["kernels"],
                                rec["profile"]["others"])
            if kind == "s2" else ""))
        check(ok, "kernel disagrees with its plain version at %s C=%d H=%d: "
              "max abs err %g > tol %g" % (kind, C, H, err, KERNEL_TOL))
        del x, w, y, yp, yl, xh, taps
    per_fwd = lambda key: sum(s[key] * s["instances_per_forward"]
                              for s in shapes)
    before_fwd = sum(BEFORE_K1_MS[(s["class"], s["C"], s["H"])]
                     * s["instances_per_forward"] for s in shapes)
    flops_fwd = per_fwd("gflop") * 1e9
    print("[kernels] kernel 1 fp32 over a batch-%d served forward's 16 calls: "
          "%.3f ms (%.1f TFLOP/s; before %.3f), plain %.3f ms, cuDNN %.3f ms, "
          "bound %.3f ms" % (BATCH, per_fwd("ms"), flops_fwd / per_fwd("ms")
                             / 1e9, before_fwd, per_fwd("plain_ms"),
                             per_fwd("library_ms"), per_fwd("bound_ms")))
    return {
        "name": "implicit_gemm_conv",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/implicit_gemm_conv.cu",
        "replaces": "mxnet_tpu/ops/pallas_conv.py:152",
        "max_abs_err": max([s["max_abs_err"] for s in shapes]
                           + list(ragged.values())),
        # times of the 16 instances of one ResNet-50 forward at batch 32
        "ms": per_fwd("ms"),
        "plain_ms": per_fwd("plain_ms"),
        "bound_ms": per_fwd("bound_ms"),
        "bound_by": ("operations" if all(s["bound_by"] == "operations"
                                         for s in shapes) else "bytes"),
        "library_ms": per_fwd("library_ms"),
        "tflops_per_forward": flops_fwd / per_fwd("ms") / 1e9,
        "occupancy": occupancy,
        "ragged_errs": ragged,
        "shapes": shapes,
    }


# --------------------------------------------------------------------------
def _wgrad_fp32_check(hc, x, dy, pads, KH, KW, label):
    """Kernel 2 (fp32) against ``taps_wgrad_plain`` on the same card
    tensors, run twice: the two results must be bit-equal, each call must
    launch the partial pass once and the reduction pass once if the plan
    splits the rows.  Returns (result, max abs error, max |dw|)."""
    N, H, W, C = x.shape
    Ho, Wo = hc._out_hw(H, W, KH, KW, pads)
    plan = hc.wgrad_fp32_plan(N * Ho * Wo, C, dy.shape[3], KH, KW,
                              _sms(x.device), (x.data_ptr(), dy.data_ptr()))
    before = (hc.wgrad_launches, hc.wgrad_reduce_launches)
    got = hc.taps_wgrad(x, dy, pads, KH, KW)
    again = hc.taps_wgrad(x, dy, pads, KH, KW)
    want = hc.taps_wgrad_plain(x, dy, pads, KH, KW)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    launched = (hc.wgrad_launches - before[0],
                hc.wgrad_reduce_launches - before[1])
    check(err <= WGRAD_TOL * scale, "kernel 2 (fp32) disagrees with its "
          "plain version at %s: %g > %g of max |dw|" % (label, err / scale,
                                                        WGRAD_TOL))
    check(torch.equal(got, again), "kernel 2 (fp32) gave other bits on the "
          "same inputs at %s" % label)
    check(launched == (2, 2 * (plan.splits > 1)), "kernel 2 (fp32) at %s "
          "launched %s (partial, reduction) in two calls, the plan %s"
          % (label, launched, plan))
    return got, err, scale


def _fp32_wgrad_occupancy_checks(hc, dev):
    """The blocks an SM holds of kernel 2's fp32 partial pass at both tiles
    and load paths, read on the card, against what its plan assumes."""
    import ctypes
    from mxnet_tpu_torch import _build
    lib = _build.load("taps_wgrad")
    n = ctypes.c_int()
    got = {}
    for tile in hc._WGRAD_FP32_TAPS:
        for vec in (0, 1):
            check(lib.mxtt_taps_wgrad_occupancy(tile, vec, dev.index,
                                                ctypes.byref(n)) == 0,
                  "occupancy query of taps_wgrad failed")
            got["tile %d vec %d" % (tile, vec)] = (n.value,
                                                   hc._WGRAD_FP32_PER_SM)
    print("[backward] kernel 2 (fp32) blocks an SM holds (card, plan): %s"
          % got)
    check(all(card == plan for card, plan in got.values()),
          "kernel 2 (fp32)'s occupancy differs from its plan's: %s" % got)
    return {k: v[0] for k, v in got.items()}


def _ragged_backward_checks(hc, dev, gen):
    """Kernel 2 and the dgrad against their plain versions at ragged
    channel counts, odd spatial dims, rows off the 16-row stage and a
    ragged row split, both of kernel 2's tiles, its 2x2 space-to-depth
    form, and an x at storage offset 1 (4 bytes off a 16-byte boundary:
    the 4-byte copy path), fp32; kernel 2 bit-equal on reruns."""
    errs = {}
    for N, C, H, W, O, off in [(3, 20, 7, 9, 70, 0), (1, 3, 1, 1, 5, 0),
                               (5, 33, 11, 13, 129, 0),
                               (4, 136, 9, 11, 72, 0),
                               (3, 24, 7, 9, 40, 1),
                               (2, 256, 14, 14, 256, 1)]:
        x = torch.randn(N, H, W, C, device=dev, generator=gen)
        if off:
            x = _at_offset_1(x)
        dy = torch.randn(N, H, W, O, device=dev, generator=gen)
        w = torch.randn(O, C, 3, 3, device=dev, generator=gen) * 0.1
        label = "N=%d C=%d %dx%d O=%d%s" % (N, C, H, W, O,
                                           " at storage offset 1" * off)
        _, err, scale = _wgrad_fp32_check(hc, x, dy, hc.S1_PADS, 3, 3, label)
        errs[label] = err / scale
        taps = hc.dgrad_taps(w)
        got = hc.taps_conv(dy, taps, hc.S1_PADS, 3, 3)
        want = hc.taps_conv_plain(dy, taps, hc.S1_PADS, 3, 3)
        check(torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL),
              "dgrad disagrees at N=%d C=%d %dx%d O=%d: max abs err %g"
              % (N, C, H, W, O, (got - want).abs().max().item()))
    x = torch.randn(2, 5, 5, 32, device=dev, generator=gen)
    dy = torch.randn(2, 5, 5, 16, device=dev, generator=gen)
    _, err, scale = _wgrad_fp32_check(hc, x, dy, hc.S2_PADS, 2, 2,
                                      "s2d 5x5 C=32 O=16")
    errs["s2d 5x5 C=32 O=16"] = err / scale
    print("[backward] ragged shapes: kernel 2 (of max |dw|, bit-equal on "
          "reruns) and dgrad match their plain versions: %s"
          % ", ".join("%s %.3g" % kv for kv in errs.items()))
    return errs


def _fp32_whole_wave(hc, x, dy, plan, want, scale):
    """Kernel 2 (fp32) at a Gluon shape with the whole-wave rule's row
    split in place of its plan's: as many splits as fill the SMs' resident
    blocks once (``wgrad_bf16_plan``'s rule, at kernel 2 fp32's blocks an
    SM), each at least the plan's fewest stages, through the C entry.
    Checked against ``want`` (within 1e-4 of ``scale``) and timed: (splits,
    ms), or (the plan's splits, None) where the two rules agree."""
    import ctypes
    N, H, W, C = x.shape
    O = dy.shape[3]
    M, bk = N * H * W, hc._WGRAD_FP32_BK
    blocks = plan.grid[0] * plan.grid[1]
    splits = max(1, min(hc._WGRAD_FP32_PER_SM * _sms(x.device) // blocks,
                        hc._cdiv(M, hc._WGRAD_FP32_MIN_STAGES * bk)))
    rows = hc._cdiv(hc._cdiv(M, splits), bk) * bk
    splits = hc._cdiv(M, rows)
    if splits == plan.splits:
        return splits, None
    out = torch.empty((9, C, O), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, 9, C, O), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    launched = (ctypes.c_int * 2)()

    def run():
        err = hc._wgrad_kernel()(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, N, H, W, C, O, 3, 3,
            1, 1, H, W, plan.tile, splits, rows, int(plan.vec),
            x.device.index, hc._stream(x.device), launched)
        check(err == 0, "kernel 2 (fp32) with %d splits failed: CUDA error "
              "%d" % (splits, err))
    run()
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    check(err <= WGRAD_TOL * scale, "kernel 2 (fp32) with the whole-wave "
          "rule's %d splits disagrees with its plan's result: %g of max |dw|"
          % (splits, err / scale))
    return splits, time_ms(run)


def _fp32_wgrad_shape(hc, N, C, H, count, gen, dev, occupancy):
    """Kernel 2 (fp32) at one Gluon shape: checked twice against its plain
    version and timed beside it, cuDNN's ``conv2d_weight`` and the bound;
    returns (record, x, dy, the OIHW weight, NCHW views)."""
    O = C
    x = torch.randn(N, H, H, C, device=dev, generator=gen)
    dy = torch.randn(N, H, H, O, device=dev, generator=gen)
    w = torch.randn(O, C, 3, 3, device=dev, generator=gen) / math.sqrt(9 * C)
    xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    flops = 2.0 * N * H * H * C * O * 9
    label = "C=O=%d %dx%d N=%d" % (C, H, H, N)
    got, err, scale = _wgrad_fp32_check(hc, x, dy, hc.S1_PADS, 3, 3, label)
    lib = torch.nn.grad.conv2d_weight(xn, w.shape, dyn, padding=1)
    err_lib = (got.reshape(3, 3, C, O).permute(3, 2, 0, 1)
               - lib).abs().max().item()
    plan = hc.wgrad_fp32_plan(N * H * H, C, O, 3, 3, _sms(dev),
                              (x.data_ptr(), dy.data_ptr()))
    ms = time_ms(lambda: hc.taps_wgrad(x, dy, hc.S1_PADS, 3, 3))
    ww_splits, ww_ms = _fp32_whole_wave(hc, x, dy, plan, got, scale)
    plain_ms = time_ms(lambda: hc.taps_wgrad_plain(x, dy, hc.S1_PADS, 3, 3))
    lib_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
        xn, w.shape, dyn, padding=1))
    bound_ms, bound_by = _bound(
        flops, 4.0 * (x.numel() + dy.numel() + 9 * C * O))
    rec = {"N": N, "C": C, "O": O, "H": H, "W": H,
           "instances_per_step": count, "gflop": flops / 1e9,
           "max_abs_err": err, "max_rel_err": err / scale,
           "tol_rel": WGRAD_TOL, "max_abs_err_vs_cudnn": err_lib,
           "tile": plan.tile, "splits": plan.splits, "rows": plan.rows,
           "blocks_per_sm": {"card": occupancy["tile %d vec %d" % (
               plan.tile, int(plan.vec))], "plan": hc._WGRAD_FP32_PER_SM},
           "whole_wave_splits": ww_splits,
           "whole_wave_ms": ms if ww_ms is None else ww_ms,
           "bit_equal_rerun": True, "ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "tflops": flops / ms / 1e9}
    print("[backward] wgrad C=O=%d %dx%d N=%d (tile %d, %d splits of %d "
          "rows, %d blocks an SM, plan %d; rerun bit-equal): max_abs_err "
          "%.3g (%.3g of max |dw|, tol %g) vs cuDNN %.3g | kernel %.4f ms "
          "(%.1f TFLOP/s), plain %.4f ms, cuDNN %.4f ms, bound %.4f ms (%s)"
          % (C, H, H, N, plan.tile, plan.splits, plan.rows,
             rec["blocks_per_sm"]["card"], hc._WGRAD_FP32_PER_SM, err,
             err / scale, WGRAD_TOL, err_lib, ms, rec["tflops"], plain_ms,
             lib_ms, bound_ms, bound_by))
    if ww_ms is not None:
        print("[backward]   the whole-wave rule's %d splits at C=O=%d %dx%d "
              "N=%d: %.4f ms (the plan's %d: %.4f ms)"
              % (ww_splits, C, H, H, N, ww_ms, plan.splits, ms))
    return rec, x, dy, w, xn, dyn


def _step_sum(records):
    """A step's sums of the per-shape records' times, and TFLOP/s."""
    out = {key: sum(r[key] * r["instances_per_step"] for r in records)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["tflops"] = sum(r["gflop"] * r["instances_per_step"]
                        for r in records) / out["ms"]
    return out


def phase_backward_kernels():
    """Kernel 2 (wgrad) and kernel 1 as dgrad against their plain versions
    at the 4 stride-1 3x3 shapes of a Gluon ResNet-50 v1, batch 32, fp32,
    kernel 2 also at batch 128; returns per-shape records (kernel 2 at
    batch 32 and 128, the dgrad) and kernel 2's ragged checks."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    ragged = _ragged_backward_checks(hc, dev, gen)
    occupancy = _fp32_wgrad_occupancy_checks(hc, dev)
    wgrad, dgrad = [], []
    for C, H, count in GLUON_3X3:
        O = C
        rec, x, dy, w, xn, dyn = _fp32_wgrad_shape(hc, BATCH, C, H, count,
                                                   gen, dev, occupancy)
        wgrad.append(rec)
        flops = 2.0 * BATCH * H * H * C * O * 9
        common = {"N": BATCH, "C": C, "O": O, "H": H, "W": H,
                  "instances_per_step": count, "gflop": flops / 1e9}

        # dgrad: kernel 1 on the cotangent with flipped, io-swapped taps
        taps = hc.dgrad_taps(w)
        got, plan, _ = _conv_fp32_call(hc, dy, taps, 1, None,
                                       "dgrad C=%d %d px" % (C, H))
        want = hc.taps_conv_plain(dy, taps, hc.S1_PADS, 3, 3)
        lib = torch.nn.grad.conv2d_input(xn.shape, w, dyn, padding=1)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_lib = (got.permute(0, 3, 1, 2) - lib).abs().max().item()
        ok = torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        ms = time_ms(lambda: hc.taps_conv(dy, hc.dgrad_taps(w), hc.S1_PADS,
                                          3, 3))
        plain_ms = time_ms(lambda: hc.taps_conv_plain(
            dy, hc.dgrad_taps(w), hc.S1_PADS, 3, 3))
        lib_ms = time_ms(lambda: torch.nn.grad.conv2d_input(
            xn.shape, w, dyn, padding=1))
        bound_ms, bound_by = _bound(
            flops, 4.0 * (dy.numel() + w.numel() + x.numel()))
        rec = dict(common, max_abs_err=err, tol=KERNEL_TOL,
                   max_abs_err_vs_cudnn=err_lib, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tile=list(plan.tile), splits=plan.splits,
                   bit_equal_rerun=True, tflops=flops / ms / 1e9)
        dgrad.append(rec)
        print("[backward] dgrad C=O=%d %dx%d N=%d (kernel 1 fp32, tile %dx%d, "
              "%d splits; rerun bit-equal): max_abs_err %.3g (tol %g) vs "
              "cuDNN %.3g | kernel %.4f ms (%.1f TFLOP/s; before %.4f), plain "
              "%.4f ms, cuDNN %.4f ms, bound %.4f ms (%s)"
              % (C, H, H, BATCH, plan.tile[0], plan.tile[1], plan.splits,
                 err, KERNEL_TOL, err_lib, ms, rec["tflops"],
                 BEFORE_DGRAD_MS[C], plain_ms, lib_ms, bound_ms, bound_by))
        check(ok, "dgrad disagrees with its plain version at C=%d H=%d: max "
              "abs err %g > tol %g" % (C, H, err, KERNEL_TOL))
        del x, dy, w, got, want, lib
    wgrad128 = []
    for C, H, count in GLUON_3X3:
        wgrad128.append(_fp32_wgrad_shape(hc, BF16_BATCH, C, H, count, gen,
                                          dev, occupancy)[0])
        torch.cuda.empty_cache()
    for batch, records in ((BATCH, wgrad), (BF16_BATCH, wgrad128)):
        t = _step_sum(records)
        ww = sum(r["whole_wave_ms"] * r["instances_per_step"]
                 for r in records)
        print("[backward] kernel 2 fp32 over a batch-%d step: %.3f ms (%.1f "
              "TFLOP/s), plain %.3f ms, cuDNN %.3f ms, bound %.3f ms; under "
              "the whole-wave rule %.3f ms"
              % (batch, t["ms"], t["tflops"], t["plain_ms"], t["library_ms"],
                 t["bound_ms"], ww))
    return wgrad, wgrad128, dgrad, ragged


# --------------------------------------------------------------------------
def _w1x1_check(hc, x, g, stride, label):
    """Kernel 12 against ``conv1x1_wgrad_plain`` on the same card tensors,
    run twice: the two results must be bit-equal, each call must launch the
    partial pass once and the reduction pass once if the plan leaves more
    than one partial.  Returns (max abs error, max |dw|, the plan)."""
    N, H, W, C = x.shape
    _, Ho, Wo, O = g.shape
    plan = hc.conv1x1_wgrad_plan(N * Ho * Wo, C, O, _sms(x.device),
                                 (x.data_ptr(), g.data_ptr()))
    before = (hc.conv1x1_wgrad_launches, hc.conv1x1_wgrad_reduce_launches)
    got = hc.conv1x1_wgrad(x, g, stride)
    again = hc.conv1x1_wgrad(x, g, stride)
    want = hc.conv1x1_wgrad_plain(x, g, stride)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    launched = (hc.conv1x1_wgrad_launches - before[0],
                hc.conv1x1_wgrad_reduce_launches - before[1])
    check(err <= W1X1_TOL * scale, "kernel 12 disagrees with its plain "
          "version at %s: %g > %g of max |dw|" % (label, err / scale,
                                                  W1X1_TOL))
    check(torch.equal(got, again), "kernel 12 gave other bits on the same "
          "inputs at %s" % label)
    check(launched == (2, 2 * (plan.workspace is not None)), "kernel 12 at "
          "%s launched %s (partial, reduction) in two calls, the plan %s"
          % (label, launched, plan))
    return err, scale, plan


def _w1x1_occupancy_checks(hc, dev):
    """The blocks an SM holds of kernel 12's partial pass at each tile and
    load path, read on the card: at least the one its plan puts there."""
    import ctypes
    from mxnet_tpu_torch import _build
    lib = _build.load("conv1x1_wgrad")
    n = ctypes.c_int()
    got = {}
    for bc, bo in ((64, 64), (128, 128), (64, 256), (256, 64), (256, 128),
                   (128, 256)):
        for vec in (0, 1):
            check(lib.mxtt_conv1x1_wgrad_occupancy(bc, bo, vec, dev.index,
                                                   ctypes.byref(n)) == 0,
                  "occupancy query of conv1x1_wgrad failed")
            got["%dx%d vec %d" % (bc, bo, vec)] = n.value
    print("[bf16-kernels] kernel 12 blocks an SM holds (card; the plan puts "
          "%d on an SM): %s" % (hc._W1X1_PER_SM, got))
    check(all(card >= hc._W1X1_PER_SM for card in got.values()),
          "kernel 12 holds fewer blocks an SM than its plan puts there: %s"
          % got)
    return got


def _bf16_close(got, want):
    """Kernel 1's bf16 output against its plain version's (BF16_RTOL,
    BF16_ATOL_REL); returns (ok, max abs error)."""
    got, want = got.float(), want.float()
    atol = BF16_ATOL_REL * want.abs().max().item()
    return (bool(torch.allclose(got, want, rtol=BF16_RTOL, atol=atol)),
            (got - want).abs().max().item())


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _at_offset_1(t):
    """``t``'s values in a contiguous tensor at storage offset 1 (one
    element off a 16-byte boundary, 2 bytes in bf16, 4 in fp32: the
    kernels' element paths)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    check(out.is_contiguous() and out.data_ptr() % 16 == t.element_size(),
          "the misaligned view is not one element off")
    return out


def _bf16_occupancy_checks(hc, dev):
    """The blocks an SM holds of each bf16 kernel, read on the card, against
    what the host plans assume."""
    import ctypes
    from mxnet_tpu_torch import _build
    lc, lw = _build.load("taps_conv_bf16"), _build.load("taps_wgrad_bf16")
    got = {}
    n = ctypes.c_int()
    for bn, per_sm, _ in hc._CONV_BF16_TILES:
        for vec in (0, 1):
            check(lc.mxtt_taps_conv_bf16_occupancy(bn, vec, dev.index,
                                                   ctypes.byref(n)) == 0,
                  "occupancy query of taps_conv_bf16 failed")
            got["conv bn %d vec %d" % (bn, vec)] = (n.value, per_sm)
    for vec in (0, 1):
        check(lw.mxtt_taps_wgrad_bf16_occupancy(vec, dev.index,
                                                ctypes.byref(n)) == 0,
              "occupancy query of taps_wgrad_bf16 failed")
        got["wgrad vec %d" % vec] = (n.value, hc._WGRAD_BF16_PER_SM)
    print("[bf16-kernels] blocks an SM holds (card, plan): %s" % got)
    check(all(card == plan for card, plan in got.values()),
          "the bf16 kernels' occupancy differs from the plans': %s" % got)


def _ragged_bf16_3x3_checks(hc, dev, randn):
    """Kernels 1 and 2 in bf16 against their plain versions at ragged
    shapes, the stride-2 class through ``conv3x3_s2``, and an operand that
    is a contiguous view at storage offset 1 (2-byte aligned: the element
    path), kernel 1's also at a Gluon shape where the plan takes the
    128-column tile, at both tiles; kernel 2 twice on the same inputs must
    give the same bits.  Each call must launch the bf16 kernel once."""
    def k1(x, taps, pads, KH, KW, label, bn=None):
        before = hc.launches_bf16
        got = (hc.taps_conv(x, taps, pads, KH, KW) if bn is None
               else hc._taps_conv_cuda(x, taps, pads, KH, KW, bn=bn))
        want = hc.taps_conv_plain(x, taps, pads, KH, KW)
        torch.cuda.synchronize()
        ok, err = _bf16_close(got, want)
        check(ok and hc.launches_bf16 == before + 1, "kernel 1 (bf16) at %s: "
              "max abs err %g, %d launches" % (label, err,
                                               hc.launches_bf16 - before))
        return err

    def k2(x, dy, pads, KH, KW, label):
        before = (hc.wgrad_launches_bf16, hc.launches_bf16)
        got = hc.taps_wgrad(x, dy, pads, KH, KW)
        again = hc.taps_wgrad(x, dy, pads, KH, KW)
        want = hc.taps_wgrad_plain(x, dy, pads, KH, KW)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() / want.abs().max().item()
        check(err <= WGRAD_TOL and hc.wgrad_launches_bf16 == before[0] + 2,
              "kernel 2 (bf16) at %s: %g of max |dw| (tol %g), %d launches"
              % (label, err, WGRAD_TOL, hc.wgrad_launches_bf16 - before[0]))
        check(torch.equal(got, again), "kernel 2 (bf16) gave other bits on "
              "the same inputs at %s" % label)
        return err

    errs = {}
    for N, H, W, C, O in RAGGED_BF16:
        label = "N=%d %dx%d C=%d O=%d" % (N, H, W, C, O)
        x = randn(N, H, W, C)
        errs["k1 " + label] = k1(x, randn(9, C, O, scale=0.2), hc.S1_PADS,
                                 3, 3, label)
        errs["k2 " + label] = k2(x, randn(N, H, W, O), hc.S1_PADS, 3, 3,
                                 label)
    # the stride-2 class, at stride 2 on the input (an odd map too)
    for shape in ((2, 8, 10, 10), (3, 24, 14, 10)):
        data = randn(*shape)
        w = randn(2 * shape[1], shape[1], 3, 3, scale=0.2)
        before = hc.launches_bf16
        got = hc._taps_conv_cuda(hc._nhwc(data), hc._s1_taps(w, data.dtype),
                                 hc.S1_PADS, 3, 3, 2)
        want = hc.taps_conv_plain(hc._nhwc(data), hc._s1_taps(w, data.dtype),
                                  hc.S1_PADS, 3, 3, 2)
        torch.cuda.synchronize()
        ok, err = _bf16_close(got, want)
        check(ok and hc.launches_bf16 == before + 1, "kernel 1 (bf16) at "
              "stride 2 at %s: max abs err %g" % (shape, err))
        errs["k1 s2 %s" % (shape,)] = err
    data = randn(2, 8, 10, 10)
    w = randn(16, 8, 3, 3, scale=0.2)
    before = hc.launches_bf16
    got = hc.conv3x3_s2(data, w)
    want = hc.conv3x3_s2_plain(data, w)
    torch.cuda.synchronize()
    ok, err = _bf16_close(got, want)
    check(ok and hc.launches_bf16 == before + 1, "kernel 1 (bf16) through "
          "conv3x3_s2 at N=2 10x10 C=8 O=16: max abs err %g" % err)
    errs["k1 s2 N=2 10x10 C=8 O=16"] = err
    # kernel 2 at 2x2 taps with the reference's stride-2 pads
    errs["k2 2x2 N=2 5x5 C=32 O=16"] = k2(randn(2, 5, 5, 32),
                                          randn(2, 5, 5, 16), hc.S2_PADS, 2, 2,
                                          "2x2 5x5 C=32")
    # an operand 2 bytes off a 16-byte boundary
    N, H, W, C, O = RAGGED_BF16[0]
    x = _at_offset_1(randn(N, H, W, C))
    errs["k1 misaligned"] = k1(x, randn(9, C, O, scale=0.2), hc.S1_PADS, 3,
                               3, "x at storage offset 1")
    errs["k2 misaligned"] = k2(x, randn(N, H, W, O), hc.S1_PADS, 3, 3,
                               "x at storage offset 1")
    # the element path at the main path's size: 28x28, 128 channels, batch
    # 128, where the plan takes the 128-column tile; both tiles
    N, H, C = BF16_BATCH, 28, 128
    x = _at_offset_1(randn(N, H, H, C))
    taps = randn(9, C, C, scale=1.0 / math.sqrt(9 * C))
    plan = hc.conv_bf16_plan(N * H * H, C, C, _sms(dev), (x.data_ptr(),))
    check(plan.bn == 128 and not plan.vec, "the plan for x at storage "
          "offset 1 at 28x28/128 is %s, not the 128-column element path"
          % (plan,))
    for bn in (128, 64):
        label = "x at storage offset 1, N=%d %dx%d C=O=%d, tile %d" % (
            N, H, H, C, bn)
        errs["k1 misaligned %dx%d C=%d tile %d" % (H, H, C, bn)] = k1(
            x, taps, hc.S1_PADS, 3, 3, label, bn)
    print("[bf16-kernels] ragged, stride-2 and misaligned shapes: kernels 1 "
          "and 2 (bf16) match their plain versions, kernel 2 bit-equal on "
          "reruns (kernel 1 max abs err, kernel 2 of max |dw|): %s"
          % ", ".join("%s %.3g" % kv for kv in errs.items()))
    return errs


def phase_bf16_kernels():
    """Phase 2g: kernel 12 (``conv1x1_wgrad.cu``) against its plain version
    at ragged and misaligned shapes, the probe's own (401,408 x 64) x
    (401,408 x 256) and the 15 1x1 shapes of a batch-128 ResNet-50 v1 step,
    every call twice and bit-equal, its occupancy against its plan's;
    kernels 1 and 2 in bf16 (``taps_conv_bf16.cu``, forward and dgrad, and
    ``taps_wgrad_bf16.cu``) at ragged, stride-2 and misaligned shapes, with
    their occupancy against the host plans', and at the 4 Gluon 3x3 shapes
    at batch 128, kernel 2 twice on the same inputs (bit-equal), kernel 1's
    forward at both of its tiles.  Times beside the plain versions', the
    bf16 tensor-core bound and cuDNN's (the yardstick only); each bf16 3x3
    kernel's step sum must be under the fp32 CUDA-core ceiling.  Returns
    per-shape records (kernel 12, kernel 2, kernel 1 forward, kernel 1
    dgrad) and the ragged shapes' errors."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(bf)

    # ragged: rows off the 64-row stage and the channel tiles, C = 8, odd
    # spatial dims at stride 2, an empty split closing a cluster, each tile;
    # each also with x at storage offset 1 (the element path)
    w1x1_ragged = {}
    for N, H, W, C, O, s in [(3, 7, 9, 24, 40, 1), (5, 10, 10, 8, 16, 1),
                             (3, 7, 9, 24, 40, 2), (2, 5, 5, 8, 8, 2),
                             (4, 11, 35, 16, 24, 1), (4, 11, 13, 64, 256, 2),
                             (6, 12, 12, 256, 64, 1), (2, 8, 8, 136, 72, 1),
                             (40, 16, 16, 520, 136, 2),
                             (3, 9, 11, 136, 512, 1)]:
        Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
        x, g = randn(N, H, W, C), randn(N, Ho, Wo, O)
        for off in (0, 1):
            label = "N=%d %dx%d C=%d O=%d stride %d%s" % (
                N, H, W, C, O, s, " at storage offset 1" * off)
            err, scale, _ = _w1x1_check(hc, _at_offset_1(x) if off else x, g,
                                        s, label)
            w1x1_ragged[label] = err / scale
    print("[bf16-kernels] ragged and misaligned shapes: kernel 12 matches "
          "its plain version, bit-equal on reruns (of max |dw|): %s"
          % ", ".join("%s %.3g" % kv for kv in w1x1_ragged.items()))
    # the probe's own shape and data scale (tools/probe_conv_fixes.py:151)
    R, Cs, Cl = BF16_BATCH * 56 * 56, 64, 256
    x = randn(R, Cs, scale=0.1).reshape(BF16_BATCH, 56, 56, Cs)
    g = randn(R, Cl, scale=0.1).reshape(BF16_BATCH, 56, 56, Cl)
    err, scale, _ = _w1x1_check(hc, x, g, 1, "the probe's shape")
    print("[bf16-kernels] kernel 12 at the probe's (%d x %d) x (%d x %d): "
          "max_abs_err %.3g (%.3g of max |dw|, tol %g)"
          % (R, Cs, R, Cl, err, err / scale, W1X1_TOL))
    # the element path at a main-path shape: 56 -> 28 px, 256 -> 128, s2
    x = _at_offset_1(randn(BF16_BATCH, 56, 56, 256))
    err, scale, plan = _w1x1_check(hc, x, randn(BF16_BATCH, 28, 28, 128), 2,
                                   "x at storage offset 1, N=128 56x56 "
                                   "C=256 O=128 stride 2")
    check(not plan.vec, "the plan for x at storage offset 1 takes the "
          "16-byte path")
    w1x1_ragged["N=128 56x56 C=256 O=128 s2 at storage offset 1"] = \
        err / scale
    print("[bf16-kernels] kernel 12 on its element path at N=128 56x56 "
          "C=256 O=128 stride 2: %.3g of max |dw|" % (err / scale))
    del x, g
    occupancy = _w1x1_occupancy_checks(hc, dev)

    w1x1 = []
    for C, O, Ho, s, count in RESNET50_1X1:
        N, H = BF16_BATCH, Ho * s
        x, g = randn(N, H, H, C), randn(N, Ho, Ho, O)
        err, scale, plan = _w1x1_check(hc, x, g, s, "C=%d O=%d %d px "
                                       "stride %d" % (C, O, H, s))
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        ms = time_ms(lambda: hc.conv1x1_wgrad(x, g, s))
        plain_ms = time_ms(lambda: hc.conv1x1_wgrad_plain(x, g, s))
        lib_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
            xn, (O, C, 1, 1), gn, stride=s))
        M = N * Ho * Ho
        flops = 2.0 * M * C * O
        # the strided pixels of x it reads, g, and the fp32 output
        bound_ms, bound_by = _bound(flops, 2.0 * M * (C + O) + 4.0 * C * O,
                                    PEAK_BF16)
        rec = {"N": N, "C": C, "O": O, "H": H, "Ho": Ho, "stride": s,
               "instances_per_step": count, "gflop": flops / 1e9,
               "tile": list(plan.tile), "splits": plan.splits,
               "rows": plan.rows, "cluster": plan.cluster,
               "blocks_per_sm": {"card": occupancy["%dx%d vec 1"
                                                   % plan.tile],
                                 "plan": hc._W1X1_PER_SM},
               "bit_equal_rerun": True,
               "max_abs_err": err, "max_rel_err": err / scale,
               "tol_rel": W1X1_TOL, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "tflops": flops / ms / 1e9}
        w1x1.append(rec)
        print("[bf16-kernels] kernel 12 C=%d O=%d %d->%d px s%d N=%d (tile "
              "%dx%d, %d splits of %d rows in clusters of %d, %d blocks an "
              "SM, plan %d; rerun bit-equal): max_abs_err %.3g (%.3g of max "
              "|dw|) | kernel %.4f ms (%.1f TFLOP/s), plain %.4f ms, cuDNN "
              "bf16 %.4f ms, bound %.4f ms (%s)"
              % (C, O, H, Ho, s, N, plan.tile[0], plan.tile[1], plan.splits,
                 plan.rows, plan.cluster, rec["blocks_per_sm"]["card"],
                 hc._W1X1_PER_SM, err, err / scale, ms, rec["tflops"],
                 plain_ms, lib_ms, bound_ms, bound_by))
        del x, g, xn, gn
    t = _step_sum(w1x1)
    print("[bf16-kernels] kernel 12 over a batch-%d step: %.3f ms (%.1f "
          "TFLOP/s), plain %.3f ms, cuDNN bf16 %.3f ms, bound %.3f ms"
          % (BF16_BATCH, t["ms"], t["tflops"], t["plain_ms"],
             t["library_ms"], t["bound_ms"]))

    ragged = _ragged_bf16_3x3_checks(hc, dev, randn)
    _bf16_occupancy_checks(hc, dev)
    wgrad, fwd, dgrad = [], [], []
    for C, H, count in GLUON_3X3:
        N, O = BF16_BATCH, C
        x, dy = randn(N, H, H, C), randn(N, H, H, O)
        w = randn(O, C, 3, 3, scale=1.0 / math.sqrt(9 * C))
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        flops = 2.0 * N * H * H * C * O * 9
        common = {"N": N, "C": C, "O": O, "H": H,
                  "instances_per_step": count, "gflop": flops / 1e9}

        got = hc.taps_wgrad(x, dy, hc.S1_PADS, 3, 3)
        again = hc.taps_wgrad(x, dy, hc.S1_PADS, 3, 3)
        want = hc.taps_wgrad_plain(x, dy, hc.S1_PADS, 3, 3)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        check(err <= WGRAD_TOL * scale, "kernel 2 (bf16) disagrees with its "
              "plain version at C=%d H=%d: %g > %g of max |dw|"
              % (C, H, err / scale, WGRAD_TOL))
        check(torch.equal(got, again), "kernel 2 (bf16) gave other bits on "
              "the same inputs at C=%d H=%d" % (C, H))
        bound_ms, bound_by = _bound(
            flops, 2.0 * (x.numel() + dy.numel()) + 4.0 * 9 * C * O,
            PEAK_BF16)
        plan = hc.wgrad_bf16_plan(N * H * H, C, O, 3, 3, _sms(dev))
        rec = dict(common, max_abs_err=err, max_rel_err=err / scale,
                   tol_rel=WGRAD_TOL, splits=plan.splits, rows=plan.rows,
                   bit_equal_rerun=True,
                   ms=time_ms(lambda: hc.taps_wgrad(x, dy, hc.S1_PADS, 3, 3)),
                   plain_ms=time_ms(lambda: hc.taps_wgrad_plain(
                       x, dy, hc.S1_PADS, 3, 3)),
                   library_ms=time_ms(lambda: torch.nn.grad.conv2d_weight(
                       xn, w.shape, dyn, padding=1)),
                   bound_ms=bound_ms, bound_by=bound_by)
        rec["tflops"] = flops / rec["ms"] / 1e9
        wgrad.append(rec)

        records = []
        for label, inp, taps, lib in (
                ("forward", x, hc._s1_taps(w, bf),
                 lambda: F.conv2d(xn, w, padding=1)),
                ("dgrad", dy, hc.dgrad_taps(w, bf),
                 lambda: torch.nn.grad.conv2d_input(xn.shape, w, dyn,
                                                    padding=1))):
            got = hc.taps_conv(inp, taps, hc.S1_PADS, 3, 3)
            want = hc.taps_conv_plain(inp, taps, hc.S1_PADS, 3, 3)
            torch.cuda.synchronize()
            ok, err = _bf16_close(got, want)
            check(ok, "kernel 1 (bf16 %s) disagrees with its plain version "
                  "at C=%d H=%d: max abs err %g" % (label, C, H, err))
            bound_ms, bound_by = _bound(
                flops, 2.0 * (x.numel() + w.numel() + dy.numel()), PEAK_BF16)
            plan = hc.conv_bf16_plan(N * H * H, C, O, _sms(dev))
            r = dict(common, max_abs_err=err, rtol=BF16_RTOL,
                     atol_rel=BF16_ATOL_REL, tile=plan.bn,
                     ms=time_ms(lambda: hc.taps_conv(inp, taps, hc.S1_PADS,
                                                     3, 3)),
                     plain_ms=time_ms(lambda: hc.taps_conv_plain(
                         inp, taps, hc.S1_PADS, 3, 3)),
                     library_ms=time_ms(lib), bound_ms=bound_ms,
                     bound_by=bound_by)
            r["tflops"] = flops / r["ms"] / 1e9
            if label == "forward":   # both tiles, for the plan's choice
                r["tile_ms"], r["tile_max_abs_err"] = {}, {}
                for bn in (64, 128):
                    def tile():
                        return hc._taps_conv_cuda(inp, taps, hc.S1_PADS, 3,
                                                  3, bn=bn)
                    ok, err = _bf16_close(tile(), want)
                    check(ok, "kernel 1 (bf16 forward) at tile %d disagrees "
                          "with its plain version at C=%d H=%d: max abs err "
                          "%g" % (bn, C, H, err))
                    r["tile_max_abs_err"][bn] = err
                    r["tile_ms"][bn] = time_ms(tile)
            records.append(r)
        fwd.append(records[0])
        dgrad.append(records[1])
        for label, r in (("kernel 2 bf16 wgrad", rec),
                         ("kernel 1 bf16 forward", records[0]),
                         ("kernel 1 bf16 dgrad", records[1])):
            print("[bf16-kernels] %s C=O=%d %dx%d N=%d: max_abs_err %.3g | "
                  "kernel %.4f ms (%.1f TFLOP/s), plain %.4f ms, cuDNN bf16 "
                  "%.4f ms, bound %.4f ms (%s)%s"
                  % (label, C, H, H, N, r["max_abs_err"], r["ms"],
                     r["tflops"], r["plain_ms"], r["library_ms"],
                     r["bound_ms"], r["bound_by"],
                     "; tile %d, tiles 64/128: %.4f/%.4f ms, max abs err "
                     "%.3g/%.3g" % (r["tile"], r["tile_ms"][64],
                                    r["tile_ms"][128],
                                    r["tile_max_abs_err"][64],
                                    r["tile_max_abs_err"][128])
                     if "tile_ms" in r else
                     "; %d splits of %d rows, rerun bit-equal"
                     % (r["splits"], r["rows"]) if "splits" in r else ""))
        del x, dy, w, xn, dyn, got, want, again
    for name, records in (("kernel 1 bf16 (forward and dgrad)", fwd + dgrad),
                          ("kernel 2 bf16", wgrad)):
        ms = sum(r["ms"] * r["instances_per_step"] for r in records)
        gflop = sum(r["gflop"] * r["instances_per_step"] for r in records)
        fma_ms = gflop * 1e9 / PEAK_FP32 * 1e3
        print("[bf16-kernels] %s over a batch-%d step: %.3f ms (%.1f "
              "TFLOP/s); the fp32 CUDA-core ceiling %.3f ms"
              % (name, BF16_BATCH, ms, gflop / ms, fma_ms))
        check(ms < fma_ms, "%s takes %.3f ms a step, not under the fp32 "
              "CUDA-core ceiling %.3f ms: not on the tensor cores"
              % (name, ms, fma_ms))
    torch.cuda.empty_cache()
    ragged.update({"k12 " + k: v for k, v in w1x1_ragged.items()})
    return w1x1, wgrad, fwd, dgrad, ragged


# --------------------------------------------------------------------------
# kernel 13: ResNet-50 v1's identity bottlenecks, (H = W, Cin, Cm, blocks a
# forward): the units after each stage's first, 2 + 3 + 5 + 2
RESNET50_IDENTITY = [(56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 5),
                     (7, 2048, 512, 2)]
# kernel 13 against its plain version: each rounds three fp32 sums to bf16,
# in another order, so an element may round to the neighbouring bf16 value
# (2^-7 relative) and carry an earlier rounding's difference (1e-3 of the
# largest |out|)
FB_RTOL = 2.0 ** -7
FB_ATOL_REL = 1e-3


def _block_inputs(N, H, W, Cin, Cm, gen, dev):
    """A random bf16 block input and He-scaled folded weights in the
    kernel's layout (the residual branch's last 1x1 scaled down, as in a
    trained ResNet), biases a tenth of unit scale."""
    bf = torch.bfloat16

    def randn(*shape, scale):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    x = torch.relu(randn(N, H, W, Cin, scale=1.0)).to(bf)
    w1 = randn(Cm, Cin, scale=math.sqrt(2.0 / Cin)).to(bf)
    w2 = randn(9, Cm, Cm, scale=math.sqrt(2.0 / (9 * Cm))).to(bf)
    w3 = randn(Cin, Cm, scale=0.2 * math.sqrt(2.0 / Cm)).to(bf)
    b = randn(3, Cin, scale=0.1)
    return x, w1, w2, w3, b


def _unfused_block(x, w1, w2, w3, b):
    """The same folded block as three channels-last cuDNN bf16 convolutions
    with bias, ReLU and the residual as PyTorch elementwise ops (the
    yardstick only: the port never calls it)."""
    Cm = w1.shape[0]
    bf = torch.bfloat16
    xc = x.permute(0, 3, 1, 2)
    W1 = w1.reshape(Cm, -1, 1, 1).contiguous(
        memory_format=torch.channels_last)
    W2 = w2.reshape(3, 3, Cm, Cm).permute(2, 3, 0, 1).contiguous(
        memory_format=torch.channels_last)
    W3 = w3.reshape(-1, Cm, 1, 1).contiguous(
        memory_format=torch.channels_last)
    h = torch.relu_(F.conv2d(xc, W1, b[0, :Cm].to(bf)))
    h = torch.relu_(F.conv2d(h, W2, b[1, :Cm].to(bf), padding=1))
    return torch.relu_(F.conv2d(h, W3, b[2].to(bf)).add_(xc))


def _block_cost(N, H, W, Cin, Cm):
    """(FLOP, bytes) of one block: x read and out written once, the folded
    weights and the fp32 biases read once."""
    flops = 2.0 * N * H * W * (2 * Cin * Cm + 9 * Cm * Cm)
    nbytes = 2.0 * 2 * N * H * W * Cin + 2.0 * (2 * Cin * Cm + 9 * Cm * Cm) \
        + 4.0 * 3 * Cin
    return flops, nbytes


# kernel 13's times in the last run of this script before its redesign
# ("NVIDIA H100 80GB HBM3, 700.00 W"), ms a call, by shape label and H; the
# record printed beside this run's times
BEFORE_K13_MS = {("ragged", 9): 0.0422, ("narrow", 15): 0.0304,
               ("probe", 28): 0.2183, ("resnet50", 56): 1.0027,
               ("resnet50", 28): 0.8599, ("resnet50", 14): 0.7516,
               ("resnet50", 7): 0.6935}
# kernel 13's layouts forced at N 3, 9x11, 128/64, (warps along the rows,
# band rows, ring depth): every layout, h2 in h1's buffer and apart, several
# bands (a ragged last one) and chunks of rows, every ring depth
FB_FORCED = [(1, 9, 2), (1, 3, 3), (2, 9, 4), (2, 2, 3), (4, 4, 3),
             (4, 9, 2), (8, 2, 2), (8, 1, 2)]


def _fb_check(hb, args, plan, label):
    """Kernel 13 at ``plan`` (None: the shape's own) against its plain
    version, run twice: within FB_RTOL and FB_ATOL_REL, bit-equal, one
    launch a call.  Returns (result, max abs error, max |out|)."""
    before = hb.launches
    got = hb._fused_bottleneck_cuda(*args, plan=plan).float()
    again = hb._fused_bottleneck_cuda(*args, plan=plan).float()
    want = hb.fused_bottleneck_plain(*args).float()
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    excess = ((got - want).abs() - FB_RTOL * want.abs()).max().item()
    err = (got - want).abs().max().item()
    check(math.isfinite(scale) and scale > 0, "kernel 13's plain output is "
          "degenerate at %s" % label)
    check(excess <= FB_ATOL_REL * scale, "kernel 13 disagrees with its plain "
          "version at %s: max |err| - rtol |want| = %g > %g of max |out| %g"
          % (label, excess / scale, FB_ATOL_REL, scale))
    check(torch.equal(got, again), "kernel 13 gave other bits on the same "
          "inputs at %s" % label)
    check(hb.launches == before + 2, "kernel 13 at %s launched %d times in "
          "two calls" % (label, hb.launches - before))
    return got, err, scale


def _fb_occupancy_checks(hb, dev, plans):
    """The card's shared memory a block against the plan's limit, and the
    blocks an SM holds at each plan's layout and bytes (one, as the plans
    assume)."""
    import ctypes
    from mxnet_tpu_torch import _build
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    check(optin == hb.SMEM_LIMIT, "the card's shared memory a block is %d "
          "bytes, the plan's limit %d" % (optin, hb.SMEM_LIMIT))
    lib = _build.load("fused_bottleneck")
    n = ctypes.c_int()
    got = {}
    for plan in plans:
        check(lib.mxtt_fused_bottleneck_occupancy(plan.wm, plan.smem,
                                                  dev.index,
                                                  ctypes.byref(n)) == 0,
              "occupancy query of fused_bottleneck failed")
        got["wm %d %d B" % (plan.wm, plan.smem)] = n.value
    print("[fused-block] shared memory a block %d B; blocks an SM holds at "
          "the plans' layouts: %s" % (optin, got))
    check(all(v == 1 for v in got.values()), "kernel 13's occupancy differs "
          "from its plans' one block an SM: %s" % got)
    return got


def phase_fused_block_kernels():
    """Phase 2h: kernel 13 (``fused_bottleneck.cu``) against
    ``fused_bottleneck_plain`` on the same bf16 card tensors at the 4
    identity-bottleneck shapes of ResNet-50 v1 at batch 128, the probe's own
    (N 32, 28x28, 512/128), two ragged ones (N 1 at 9x11; a narrow 128/32
    block at 15x17) and each arm of its plan forced at one shape, within
    FB_RTOL and FB_ATOL_REL, bit-equal on reruns.  Each with its time
    beside the time before its redesign, the plain version's, the unfused
    cuDNN bf16 sequence's on the same folded weights (the yardstick) and
    the bound.  Returns per-shape records."""
    from mxnet_tpu_torch.ops import hopper_block as hb
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    sms = _sms(dev)
    forced = {}
    for wm, R, stages in FB_FORCED:
        plan = hb._plan_for(3, 9, 11, 128, 64, min(sms, 5), wm, R, stages)
        label = "wm %d, %d-row bands, %d slices, h2 %s" % (
            wm, R, stages, "in h1" if hb._h2_in_h1(wm, R, 11, 64) else "apart")
        args = _block_inputs(3, 9, 11, 128, 64, gen, dev)
        _, err, scale = _fb_check(hb, args, plan, label)
        forced[label] = err / scale
    print("[fused-block] kernel 13 at N=3 9x11 128/64 with each arm forced "
          "(rerun bit-equal), max |err| of max |out|: %s"
          % ", ".join("%s %.3g" % kv for kv in forced.items()))
    shapes = [("ragged", 1, 9, 11, 256, 64, 0),
              ("narrow", 3, 15, 17, 128, 32, 0),
              ("probe", 32, 28, 28, 512, 128, 0)] + [
        ("resnet50", BF16_BATCH, H, H, Cin, Cm, count)
        for H, Cin, Cm, count in RESNET50_IDENTITY]
    records, plans = [], []
    for label, N, H, W, Cin, Cm, count in shapes:
        args = _block_inputs(N, H, W, Cin, Cm, gen, dev)
        plan = hb.fused_bottleneck_plan(N, H, W, Cin, Cm, sms)
        plans.append(plan)
        _, err, scale = _fb_check(hb, args, None, "%s N=%d %dx%d %d/%d"
                                  % (label, N, H, W, Cin, Cm))
        flops, nbytes = _block_cost(N, H, W, Cin, Cm)
        bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16)
        rec = {"shape": label, "N": N, "H": H, "W": W, "Cin": Cin, "Cm": Cm,
               "instances_per_forward": count, "gflop": flops / 1e9,
               "plan": plan._asdict(), "bit_equal_rerun": True,
               "max_abs_err": err, "max_out": scale, "rtol": FB_RTOL,
               "atol_rel": FB_ATOL_REL,
               "ms": time_ms(lambda: hb.fused_bottleneck(*args)),
               "plain_ms": time_ms(lambda: hb.fused_bottleneck_plain(*args),
                                   iters=5, warmup=1),
               "library_ms": time_ms(lambda: _unfused_block(*args)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rec["tflops"] = flops / rec["ms"] / 1e9
        records.append(rec)
        print("[fused-block] kernel 13 %s N=%d %dx%d %d/%d (wm %d, %d-row "
              "bands, %d slices, grid %d; rerun bit-equal): max_abs_err %.3g "
              "(max |out| %.3g) | kernel %.4f ms (%.1f TFLOP/s; before %.4f), "
              "plain %.4f ms, unfused cuDNN bf16 %.4f ms, bound %.4f ms (%s)"
              % (label, N, H, W, Cin, Cm, plan.wm, plan.rows, plan.stages,
                 plan.grid, err, scale, rec["ms"], rec["tflops"],
                 BEFORE_K13_MS[(label, H)], rec["plain_ms"], rec["library_ms"],
                 bound_ms, bound_by))
        del args
    _fb_occupancy_checks(hb, dev, plans)
    fwd = [r for r in records if r["instances_per_forward"]]
    print("[fused-block] a ResNet-50 forward's %d blocks at batch %d: kernel "
          "%.4f ms (before %.4f), plain %.4f ms, unfused cuDNN %.4f ms, bound "
          "%.4f ms" % tuple(
              [sum(r["instances_per_forward"] for r in fwd), BF16_BATCH,
               sum(r["ms"] * r["instances_per_forward"] for r in fwd),
               sum(BEFORE_K13_MS[(r["shape"], r["H"])]
                   * r["instances_per_forward"] for r in fwd)]
              + [sum(r[k] * r["instances_per_forward"] for r in fwd)
                 for k in ("plain_ms", "library_ms", "bound_ms")]))
    torch.cuda.empty_cache()
    return records, forced


# --------------------------------------------------------------------------
LSTM_FWD_TOL = 1e-5     # max |kernel 8 - plain|, every output
LSTM_BWD_TOL = 1e-4     # max |kernel 9 - plain| / max |plain|, every output
# the bench's LM (bench.py:205-224): vocab, embed = hidden, layers, bptt,
# batch, dropout, SGD learning rate
LM = dict(vocab=33278, hidden=650, layers=2, bptt=35, batch=128,
          dropout=0.2, lr=0.5)
LM_UPDATE_TOL = 0.01    # first step on the card vs the CPU, per parameter
# phase 17's bucket lengths that phase 2c also checks at the LM's B and H
# (20 and 30 lie between these and the LM's 35)
BUCKET_KERNEL_T = (10, 40)
KEEP_TOL = 0.005        # dropout keep rate 0.8 within this


def _lstm_inputs(T, B, H, gen, dev):
    """Seeded fp32 inputs of kernels 8 and 9 at (T, B, H), LSTM-scaled:
    projections of unit scale, R ~ N(0, 1/H)."""
    r = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=gen) \
        * scale  # noqa: E731
    return dict(xp=r(T, B, 4 * H), h0=r(B, H, scale=0.3),
                c0=r(B, H, scale=0.3), R=r(4 * H, H, scale=H ** -0.5),
                bR=r(4 * H, scale=0.1), dys=r(T, B, H), dhT=r(B, H),
                dcT=r(B, H))


def _lstm_check(hr, c, T, B, H):
    """Kernels 8 and 9 against their plain versions on the same inputs;
    returns (max forward abs err, max backward err / max |value|)."""
    got = hr.lstm_fwd(c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
    want = hr.lstm_fwd_plain(c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
    torch.cuda.synchronize()
    ferr = {n: (g - w).abs().max().item() for n, g, w in
            zip(("ys", "hT", "cT", "gates", "cs"), got, want)}
    check(max(ferr.values()) <= LSTM_FWD_TOL, "kernel 8 disagrees with its "
          "plain version at T=%d B=%d H=%d: %s > %g" % (T, B, H, ferr,
                                                        LSTM_FWD_TOL))
    args = (want[3], want[4], c["c0"], c["dys"], c["dhT"], c["dcT"], c["R"])
    got = hr.lstm_bwd(*args)
    want_b = hr.lstm_bwd_plain(*args)
    torch.cuda.synchronize()
    berr = {n: (g - w).abs().max().item() / w.abs().max().item() for n, g, w
            in zip(("dxp", "dh0", "dc0"), got, want_b)}
    check(max(berr.values()) <= LSTM_BWD_TOL, "kernel 9 disagrees with its "
          "plain version at T=%d B=%d H=%d: %s > %g of max |value|"
          % (T, B, H, berr, LSTM_BWD_TOL))
    return max(ferr.values()), max(berr.values()), args


# kernels 8 and 9's times a call at the LM's shape in the last run of this
# script before their redesign ("NVIDIA H100 80GB HBM3, 700.00 W"), ms
BEFORE_K89_MS = {"lstm_fwd": 1.0994, "lstm_bwd": 1.7761}


def _lstm_rerun(hr, c):
    """Kernels 8 and 9 twice on the same inputs: every output bit-equal."""
    fwd_in = (c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
    f1, f2 = hr.lstm_fwd(*fwd_in), hr.lstm_fwd(*fwd_in)
    bwd_in = (f1[3], f1[4], c["c0"], c["dys"], c["dhT"], c["dcT"], c["R"])
    b1, b2 = hr.lstm_bwd(*bwd_in), hr.lstm_bwd(*bwd_in)
    torch.cuda.synchronize()
    return (all(torch.equal(x, y) for x, y in zip(f1, f2)),
            all(torch.equal(x, y) for x, y in zip(b1, b2)))


def _cudnn_lstm(hr, c, bargs, gen, dev):
    """The yardstick: cuDNN's one-layer LSTM (``torch.nn.LSTM``) on the
    same function as kernels 8 and 9 at ``c``'s shape (its input weights
    make x @ W^T + bW the projection the kernels are given).  Returns its
    forward ms with the input projection, the projection's matmul alone,
    its output's max abs difference from kernel 8's, its data-and-state
    backward ms with dx, and dx = dxp @ W alone; cuDNN's recurrence alone
    is each difference."""
    T, B, H = c["dys"].shape
    lstm = torch.nn.LSTM(H, H).to(dev)
    x = torch.randn(T, B, H, device=dev, generator=gen)
    W = torch.randn(4 * H, H, device=dev, generator=gen) * H ** -0.5
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(W)
        lstm.bias_ih_l0.zero_()
        lstm.weight_hh_l0.copy_(c["R"])
        lstm.bias_hh_l0.copy_(c["bR"])
    h0, c0 = c["h0"][None], c["c0"][None]
    xp = torch.matmul(x, W.t()).contiguous()
    ys = hr.lstm_fwd(xp, c["h0"], c["c0"], c["R"], c["bR"])[0]
    with torch.no_grad():
        y_lib = lstm(x, (h0, c0))[0]
    err_lib = (ys - y_lib).abs().max().item()
    with torch.no_grad():
        lib_ms = time_ms(lambda: lstm(x, (h0, c0)))
    proj_ms = time_ms(lambda: torch.matmul(x, W.t()))
    # cuDNN's backward of the data and states only (its weights need no
    # gradient): the recurrence backward plus dx = dxp @ W
    xg = x.clone().requires_grad_()
    h0g, c0g = h0.clone().requires_grad_(), c0.clone().requires_grad_()
    for p in lstm.parameters():
        p.requires_grad_(False)
    y, (hT, cT) = lstm(xg, (h0g, c0g))
    grads = (c["dys"], c["dhT"][None], c["dcT"][None])
    lib_bms = time_ms(lambda: torch.autograd.grad(
        (y, hT, cT), (xg, h0g, c0g), grads, retain_graph=True))
    dx_ms = time_ms(lambda: torch.matmul(bargs[0], W))
    return lib_ms, proj_ms, err_lib, lib_bms, dx_ms


def phase_lstm_kernels():
    """Kernels 8 and 9 against their plain versions at two ragged shapes,
    at the edges of their envelope, at phase 17's T-10 and T-40 buckets
    and at the LM's (T=35, B=128, H=650: both layers' recurrences have
    this shape, since embed = hidden), with bit-equal reruns, the plans
    beside the card's occupancy, times, bounds, and cuDNN's LSTM as the
    yardstick; returns the two ``kernels`` entries
    (without ``launches``)."""
    from mxnet_tpu_torch.ops import hopper_rnn as hr
    fp32_exact()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # ragged shapes, then the envelope's edges: B = 1024 (batch tiles) and
    # H = 2048 (R streamed, not resident)
    for T, B, H in [(7, 3, 100), (5, 33, 257), (2, 1024, 40), (3, 64, 2048)]:
        c = _lstm_inputs(T, B, H, gen, dev)
        ferr, berr, _ = _lstm_check(hr, c, T, B, H)
        print("[lstm-kernels] T=%d B=%d H=%d: kernel 8 max abs err %.3g (tol "
              "%g), kernel 9 %.3g of max |value| (tol %g)"
              % (T, B, H, ferr, LSTM_FWD_TOL, berr, LSTM_BWD_TOL))
        if H == 2048:
            same = _lstm_rerun(hr, c)
            print("[lstm-kernels] T=%d B=%d H=%d rerun bit-equal: kernel 8 %s, "
                  "kernel 9 %s" % (T, B, H, *same))
            check(all(same), "LSTM kernels not bit-equal on a rerun at H=2048")
    # phase 17's buckets at the LM's width: against the plain versions,
    # bit-equal on a rerun, timed
    B, H = LM["batch"], LM["hidden"]
    bucket_calls = []
    for T in BUCKET_KERNEL_T:
        c = _lstm_inputs(T, B, H, gen, dev)
        ferr, berr, bargs = _lstm_check(hr, c, T, B, H)
        same = _lstm_rerun(hr, c)
        check(all(same), "LSTM kernels not bit-equal on a rerun at T=%d "
              "B=%d H=%d" % (T, B, H))
        fwd_args = (c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
        rec = {"T": T, "B": B, "H": H, "fwd_err": ferr, "bwd_err": berr,
               "rerun_bit_equal": True,
               "fwd_ms": time_ms(lambda: hr.lstm_fwd(*fwd_args)),
               "fwd_plain_ms": time_ms(lambda: hr.lstm_fwd_plain(*fwd_args)),
               "bwd_ms": time_ms(lambda: hr.lstm_bwd(*bargs)),
               "bwd_plain_ms": time_ms(lambda: hr.lstm_bwd_plain(*bargs))}
        rec["fwd_bound_ms"], rec["bwd_bound_ms"] = (
            _bound(*_lstm_cost(T, B, H, kind))[0] for kind in ("fwd", "bwd"))
        lib_ms, proj_ms, _, lib_bms, dx_ms = _cudnn_lstm(hr, c, bargs, gen,
                                                         dev)
        rec["fwd_library_recurrence_ms"] = lib_ms - proj_ms
        rec["bwd_library_recurrence_ms"] = lib_bms - dx_ms
        bucket_calls.append(rec)
        print("[lstm-kernels] T=%d B=%d H=%d (a bucket): kernel 8 %.4f ms "
              "(plain %.4f, bound %.4f, cuDNN's recurrence alone %.4f: "
              "%.4f less its projection %.4f), err %.3g; kernel 9 %.4f ms "
              "(plain %.4f, bound %.4f, cuDNN's recurrence alone %.4f: "
              "%.4f less dx %.4f), err %.3g of max; reruns bit-equal"
              % (T, B, H, rec["fwd_ms"], rec["fwd_plain_ms"],
                 rec["fwd_bound_ms"], lib_ms - proj_ms, lib_ms, proj_ms,
                 ferr, rec["bwd_ms"], rec["bwd_plain_ms"],
                 rec["bwd_bound_ms"], lib_bms - dx_ms, lib_bms, dx_ms, berr))
    T = LM["bptt"]
    c = _lstm_inputs(T, B, H, gen, dev)
    ferr, berr, bargs = _lstm_check(hr, c, T, B, H)
    same = _lstm_rerun(hr, c)
    print("[lstm-kernels] T=%d B=%d H=%d rerun bit-equal: kernel 8 %s, kernel "
          "9 %s" % (T, B, H, *same))
    check(all(same), "LSTM kernels not bit-equal on a rerun at the LM's shape")
    geometry = {}
    for name in ("lstm_fwd", "lstm_bwd"):
        geometry[name] = g = hr.geometry(name, B, H)
        print("[lstm-kernels] %s plan at B=%d H=%d: %s; the card holds %d "
              "block(s) an SM of it, the plan needs %d blocks on %d SMs"
              % (name, B, H, {k: v for k, v in g.items()
                              if k != "blocks_per_sm"},
                 g["blocks_per_sm"], g["blocks"], sms))
        check(g["blocks_per_sm"] * sms >= g["blocks"], "%s: %d blocks do not "
              "fit %d an SM" % (name, g["blocks"], g["blocks_per_sm"]))
    fwd_args = (c["xp"], c["h0"], c["c0"], c["R"], c["bR"])
    ms = time_ms(lambda: hr.lstm_fwd(*fwd_args))
    plain_ms = time_ms(lambda: hr.lstm_fwd_plain(*fwd_args))
    bms = time_ms(lambda: hr.lstm_bwd(*bargs))
    bplain_ms = time_ms(lambda: hr.lstm_bwd_plain(*bargs))

    lib_ms, proj_ms, err_lib, lib_bms, dx_ms = _cudnn_lstm(hr, c, bargs,
                                                           gen, dev)
    flops = _lstm_cost(T, B, H, "fwd")[0]
    fbound, fby = _bound(*_lstm_cost(T, B, H, "fwd"))
    bbound, bby = _bound(*_lstm_cost(T, B, H, "bwd"))
    print("[lstm-kernels] T=%d B=%d H=%d fp32: kernel 8 %.4f ms (%.2f TFLOP/s"
          "), plain %.4f ms, bound %.4f ms (%s); kernel 9 %.4f ms (%.2f "
          "TFLOP/s), plain %.4f ms, bound %.4f ms (%s); max err %.3g / %.3g "
          "of max (tol %g / %g)" % (T, B, H, ms, flops / ms / 1e9, plain_ms,
                                    fbound, fby, bms, flops / bms / 1e9,
                                    bplain_ms, bbound, bby, ferr, berr,
                                    LSTM_FWD_TOL, LSTM_BWD_TOL))
    print("[lstm-kernels] cuDNN LSTM (one layer, TF32 off, same weights): "
          "forward %.4f ms with its input projection (the projection's "
          "matmul alone %.4f ms, so the recurrence %.4f ms), output within "
          "%.3g of kernel 8's; data and state backward %.4f ms with dx (dxp "
          "@ W alone %.4f ms, so the recurrence %.4f ms)"
          % (lib_ms, proj_ms, lib_ms - proj_ms, err_lib, lib_bms, dx_ms,
             lib_bms - dx_ms))
    for name, now, rec in (("lstm_fwd", ms, lib_ms - proj_ms),
                           ("lstm_bwd", bms, lib_bms - dx_ms)):
        print("[lstm-kernels] kernel %d a call: %.4f ms, before the redesign "
              "%.4f ms (the last run before it, quoted); cuDNN's recurrence "
              "alone %.4f ms; half the bound %.4f ms"
              % (8 if name == "lstm_fwd" else 9, now, BEFORE_K89_MS[name],
                 rec, (fbound if name == "lstm_fwd" else bbound) / 2))
    common = {"route": "cuda", "T": T, "B": B, "H": H,
              "calls_per_step": LM["layers"]}
    k8 = dict(common, name="lstm_fwd", source="mxnet_tpu_torch/csrc/"
              "lstm_fwd.cu", replaces="mxnet_tpu/ops/pallas_rnn.py:82",
              max_abs_err=ferr, call_ms=ms, call_plain_ms=plain_ms,
              call_bound_ms=fbound, bound_by=fby, call_library_ms=lib_ms,
              library="torch.nn.LSTM forward (cuDNN), input projection "
                      "included", projection_ms=proj_ms,
              library_recurrence_ms=lib_ms - proj_ms,
              max_abs_err_vs_cudnn=err_lib, tflops=flops / ms / 1e9,
              plan=geometry["lstm_fwd"])
    k9 = dict(common, name="lstm_bwd", source="mxnet_tpu_torch/csrc/"
              "lstm_bwd.cu", replaces="mxnet_tpu/ops/pallas_rnn.py:157",
              max_abs_err=berr, max_err_is="of max |value|", call_ms=bms,
              call_plain_ms=bplain_ms, call_bound_ms=bbound, bound_by=bby,
              call_library_ms=lib_bms,
              library="torch.autograd.grad of torch.nn.LSTM (cuDNN) for "
                      "data and states, dx included",
              dx_ms=dx_ms, library_recurrence_ms=lib_bms - dx_ms,
              tflops=flops / bms / 1e9, plan=geometry["lstm_bwd"])
    for k, kind in ((k8, "fwd"), (k9, "bwd")):
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            k[key] = k["call_" + key] * LM["layers"]    # a training step
        # phase 17's bucket lengths at the same B and H
        k["bucket_calls"] = [{
            "T": r["T"], "max_abs_err": r[kind + "_err"],
            "call_ms": r[kind + "_ms"], "call_plain_ms": r[kind + "_plain_ms"],
            "call_bound_ms": r[kind + "_bound_ms"],
            "call_library_recurrence_ms": r[kind + "_library_recurrence_ms"]}
            for r in bucket_calls]
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            r["max_abs_err"] for r in k["bucket_calls"]])
    return [k8, k9]


def _lstm_cost(T, B, H, kind):
    """(FLOPs, bytes) of one kernel-8 ("fwd") or kernel-9 ("bwd") call:
    the recurrent product's 2·T·B·H·4H, and each input read and output
    written once (kernel 8: xp, R, bR, h0, c0 in, ys, gates, cs, hT, cT
    out; kernel 9: gates, cs, dys, R, c0, dhT, dcT in, dxp, dh0, dc0
    out)."""
    flops = 2.0 * T * B * H * 4 * H
    if kind == "fwd":
        nbytes = 4.0 * (T * B * 4 * H * 2 + T * B * H * 2 + 4 * H * H
                        + 4 * H + 4 * B * H)
    else:
        nbytes = 4.0 * (T * B * 4 * H * 2 + T * B * H * 2 + 4 * H * H
                        + 5 * B * H)
    return flops, nbytes


# --------------------------------------------------------------------------
def gluon_lm(ctx, dropout):
    """bench.py's LM (bench.py:218-238) on ``ctx``: Embedding(33278, 650)
    -> LSTM(650, 2 layers) -> Dense(33278, flatten=False), weights from
    ``initialize()`` after ``random.seed(SEED)``, deferred shapes resolved
    by one batch, then hybridized; token ids from numpy seed 0, all below
    256, as the bench makes them."""
    from mxnet_tpu_torch import gluon, name, nd, random
    from mxnet_tpu_torch.gluon import nn, rnn
    random.seed(SEED)
    with name.NameManager():
        net = gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Embedding(LM["vocab"], LM["hidden"]))
            net.add(rnn.LSTM(LM["hidden"], num_layers=LM["layers"],
                             dropout=dropout))
            net.add(nn.Dense(LM["vocab"], flatten=False))
    net.initialize(ctx=ctx)
    np.random.seed(SEED)
    toks = np.random.randint(0, min(256, LM["vocab"]),
                             (LM["bptt"], LM["batch"]))
    x, y = nd.array(toks, ctx=ctx), nd.array(toks, ctx=ctx)
    net(x).wait_to_read()
    net.hybridize()
    return net, x, y


def _lm_trainer(net):
    from mxnet_tpu_torch import FusedTrainer, gluon
    return FusedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": LM["lr"]})


def phase_lm_training(card):
    """Train the bench's LM at full width on gpu(0): launch counts, train
    tokens/s, falling losses, and dropout on the card."""
    from mxnet_tpu_torch import gpu, random
    from mxnet_tpu_torch.ops import hopper_rnn as hr
    from mxnet_tpu_torch.ops import rnn as rnn_ops
    fp32_exact()
    t0 = time.perf_counter()
    net, x, y = gluon_lm(gpu(0), LM["dropout"])
    params = net.collect_params()
    n_params = sum(int(np.prod(p.shape)) for p in params.values())
    ft = _lm_trainer(net)
    print("[lm-training] %d parameters in %d arrays, made on gpu(0) in "
          "%.2f s" % (n_params, len(params), time.perf_counter() - t0))
    tokens = LM["bptt"] * LM["batch"]

    # the main path: counts zeroed just before the first step, read after
    # the last timed one
    hr.lstm_fwd_launches = 0
    hr.lstm_bwd_launches = 0
    losses = []
    times = timed_steps(lambda: ft.step(x, y),
                        lambda loss: losses.append(float(loss.asnumpy())))
    steps = len(losses)
    launches = {"lstm_fwd": hr.lstm_fwd_launches,
                "lstm_bwd": hr.lstm_bwd_launches}
    want = LM["layers"]
    print("[lm-training] %d steps ran %s launches (expected %d each a step)"
          % (steps, launches, want))
    check(all(v == want * steps for v in launches.values()),
          "launch counts %s over %d steps, expected %d each a step"
          % (launches, steps, want))
    check(all(math.isfinite(v) for v in losses), "non-finite loss: %s"
          % losses)
    check(losses[-1] < losses[0], "the loss did not fall over %d steps: %s"
          % (steps, losses))
    step_ms = float(np.median(times)) * 1e3
    tps = tokens / (step_ms / 1e3)
    print("[lm-training] vocab %d, hidden %d, %d layers, bptt %d, batch %d, "
          "fp32: %d timed steps after %d warm-up, median %.2f ms (min %.2f, "
          "max %.2f), %.1f train tokens/s on %s; losses %s"
          % (LM["vocab"], LM["hidden"], LM["layers"], LM["bptt"],
             LM["batch"], TIMED_STEPS, WARMUP_STEPS, step_ms,
             min(times) * 1e3, max(times) * 1e3, tps, card,
             ["%.4f" % v for v in losses]))

    # dropout on the card: the keep rate of one layer's mask, and the same
    # first loss from one seed
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ones = torch.ones((LM["bptt"], LM["batch"], LM["hidden"]), device="cuda")
    keep = (rnn_ops.dropout(ones, LM["dropout"], gen) != 0).float().mean()
    keep = keep.item()
    firsts = []
    for s in (SEED + 7, SEED + 7, SEED + 8):
        random.seed(s)
        firsts.append(float(_lm_trainer(net).step(x, y).asnumpy()))
    print("[lm-training] dropout: keep rate %.5f (want %.1f within %g); "
          "first losses %s for seeds 7, 7, 8"
          % (keep, 1 - LM["dropout"], KEEP_TOL, firsts))
    check(abs(keep - (1 - LM["dropout"])) <= KEEP_TOL,
          "dropout keep rate %g" % keep)
    check(firsts[0] == firsts[1] and firsts[0] != firsts[2],
          "dropout does not follow the seed: %s" % firsts)
    return launches, {
        "tokens_per_s": tps, "step_ms": step_ms,
        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
        "steps": steps, "losses": losses, "dropout_keep_rate": keep,
        "config": dict(LM, dtype="float32")}, (ft, x, y)


def phase_lm_vs_cpu(card):
    """The first step of the full-width LM without dropout, on the card
    and on the CPU (plain versions), from the same weights and batch."""
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.weights import from_jax_block
    fp32_exact()
    net, x, y = gluon_lm(gpu(0), 0.0)
    w_init = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    ft = _lm_trainer(net)
    loss = float(ft.step(x, y).asnumpy())
    ft.sync_params()
    w_gpu = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    del ft, net
    cnet, cx, cy = gluon_lm(cpu(), 0.0)
    from_jax_block(w_init, cnet, cpu())
    cft = _lm_trainer(cnet)
    t0 = time.perf_counter()
    closs = float(cft.step(cx, cy).asnumpy())
    cpu_s = time.perf_counter() - t0
    cft.sync_params()
    rel_loss = abs(loss - closs) / abs(closs)
    worst, worst_name = 0.0, None
    for k, p in cnet.collect_params().items():
        want = p.data().asnumpy() - w_init[k]
        got = w_gpu[k] - w_init[k]
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        if err > worst:
            worst, worst_name = err, k
    print("[lm-vs-cpu] first step without dropout vs the CPU (plain "
          "versions, %.1f s): loss %.6f vs %.6f (rel %.3g, tol %g); every "
          "update within %.3g of its norm (tol %g; largest: %s)"
          % (cpu_s, loss, closs, rel_loss, LOSS_RTOL, worst, LM_UPDATE_TOL,
             worst_name))
    check(rel_loss <= LOSS_RTOL, "first-step loss differs from the CPU by "
          "%g > %g" % (rel_loss, LOSS_RTOL))
    check(worst <= LM_UPDATE_TOL, "the update of %s differs from the CPU's "
          "by %g > %g of its norm" % (worst_name, worst, LM_UPDATE_TOL))
    return {"loss_rel_err": rel_loss, "update_rel_err_max": worst,
            "update_rel_err_max_param": worst_name, "cpu_step_s": cpu_s}


def _lm_group(name: str) -> str:
    lname = name.lower()
    if "lstm_fwd_kernel" in name:
        return "kernel 8 (lstm_fwd)"
    if "lstm_bwd_kernel" in name:
        return "kernel 9 (lstm_bwd)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    if "multi_tensor_apply" in lname or "foreach" in lname:
        return "optimizer (SGD)"
    if any(k in lname for k in ("gemm", "xmma", "cutlass", "sm80_", "sm90_",
                                "nvjet", "splitk")):
        return "cuBLAS (projections, decoder, dR)"
    if "embedding" in lname or "indexing_backward" in lname \
            or "radix" in lname or "sort" in lname:
        return "embedding"
    if any(k in lname for k in ("logsumexp", "softmax", "gather", "scatter",
                                "log_", "exp")):
        return "cross-entropy"
    return "dropout and elementwise"


def phase_lm_profile(card, trainer, step_ms):
    """One profiled LM step: device time and launches by group, and the
    device's idle share against the unprofiled median step."""
    ft, x, y = trainer
    kernels, wall_ms = profiled_kernels(lambda: ft.step(x, y), 1,
                                        "lm-profile")
    groups, counts, by_name = {}, {}, {}
    for e in kernels:
        g = _lm_group(e.name)
        us = e.time_range.elapsed_us()
        groups[g] = groups.get(g, 0.0) + us
        counts[g] = counts.get(g, 0) + 1
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    device_ms = sum(groups.values()) / 1e3
    check(device_ms > 0, "the profiler recorded no device time")
    traced = (counts.get("kernel 8 (lstm_fwd)", 0),
              counts.get("kernel 9 (lstm_bwd)", 0))
    check(traced == (LM["layers"], LM["layers"]), "profile saw %d kernel-8 "
          "and %d kernel-9 launches in one step" % traced)
    idle = max(0.0, 1 - device_ms / step_ms)
    print("[lm-profile] one step: %.2f ms device busy, %.2f ms wall "
          "unprofiled (%.1f%% idle), %.2f ms wall profiled; %d launches on "
          "%s" % (device_ms, step_ms, 100 * idle, wall_ms, len(kernels),
                  card))
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[lm-profile]   %-36s %8.3f ms/step (%.1f%%), %4d launches"
              % (g, us / 1e3, 100.0 * us / 1e3 / device_ms, counts[g]))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print("[lm-profile]   top: %7.3f ms/step, %3d launches  %s [%s]"
              % (us / 1e3, n, name[:80], _lm_group(name)))
    return {"step_device_ms": device_ms, "idle_share": idle,
            "step_wall_ms_profiled": wall_ms, "launches_per_step":
            len(kernels), "device_ms_by_group": {g: us / 1e3 for g, us in
                                                 groups.items()},
            "launches_by_group": counts}


# --------------------------------------------------------------------------
ATTN_FWD_TOL = 1e-5     # max |kernel 3 or 5 - plain|, out and lse
ATTN_BWD_TOL = 1e-4     # max |fused backward - plain| / max |plain|
# (B, H, Tq, Tk, D, causal): the main path's first, then ragged ones
ATTN_SHAPES = [(16, 12, 1024, 1024, 64, True), (2, 4, 128, 128, 16, True),
               (1, 3, 1000, 1000, 64, True), (2, 2, 77, 77, 32, False),
               (1, 2, 128, 384, 128, False), (1, 1, 256, 128, 64, True)]
# bench.py --transformer (bench.py:646-722): config, batch, SGD, init seed
TFM = dict(config="gpt2-small", batch=16, lr=0.05, momentum=0.9,
           init_seed=7, data_seed=0, num_batches=8)
TFM_UPDATE_TOL = 0.01   # first step on the card vs the CPU, per parameter
TFM_CPU_STEP_LIMIT_S = 60.0


def _visible_pairs(Tq, Tk, causal):
    """(query, key) pairs the mask lets through, per (batch, head)."""
    if not causal:
        return Tq * Tk
    return sum(min(i + 1, Tk) for i in range(Tq))


def _attn_costs(B, H, Tq, Tk, D, causal):
    """FLOPs and bytes of kernels 3/5 and of the backward at one shape: 2
    FLOP per multiply-add over the visible pairs (2 products of D terms
    forward; 5 backward, S, dP, dV, dK and dQ, whichever kernels compute
    them), each fp32 input read once and each output written once."""
    BH, pairs, f4 = B * H, _visible_pairs(Tq, Tk, causal), 4.0
    q_bytes, kv_bytes, row_bytes = f4 * BH * Tq * D, f4 * BH * Tk * D, \
        f4 * BH * Tq
    return {
        "flash_fwd": (4.0 * pairs * D * BH, 2 * q_bytes + 2 * kv_bytes),
        "flash_fwd_lse": (4.0 * pairs * D * BH,
                          2 * q_bytes + 2 * kv_bytes + row_bytes),
        "flash_bwd": (10.0 * pairs * D * BH,
                      3 * q_bytes + 4 * kv_bytes + 2 * row_bytes)}


def _fwd_check(ha, q, k, v, causal, sc, tag):
    """Kernels 3, 5 and 4 (the three epilogues of ``flash_attn_fwd.cu``)
    against ``flash_fwd_plain`` and ``flash_stats_plain`` on the same
    inputs, each run twice and required bit-equal: out, lse and m within
    ``ATTN_FWD_TOL`` absolute, acc and l within ``STATS_TOL`` of their
    largest |value|.  Returns ({kernel: error}, (out, lse) of the plain
    version, kernel 4's (acc, m, l), its errors (acc, m, l))."""
    out, lse = ha.flash_fwd_plain(q, k, v, causal, sc)
    stats = ha.flash_stats_plain(q, k, v, causal, sc)
    runs = [(ha.flash_fwd(q, k, v, causal, sc),
             ha.flash_fwd_lse(q, k, v, causal, sc),
             ha.flash_attention_stats(q, k, v, causal, sc)) for _ in range(2)]
    torch.cuda.synchronize()
    (out3, (out5, lse5), got4), again = runs
    check(torch.equal(out3, again[0]) and all(
        torch.equal(a, b) for a, b in zip((out5, lse5) + tuple(got4),
                                          again[1] + tuple(again[2]))),
        "the forward kernels are not bit-equal on a rerun at %s" % (tag,))
    stats_err = _stats_err(got4, stats)
    err = {"flash_fwd": (out3 - out).abs().max().item(),
           "flash_fwd_lse": max((out5 - out).abs().max().item(),
                                (lse5 - lse).abs().max().item()),
           "flash_attention_stats": max(stats_err)}
    for name, e in err.items():
        tol = STATS_TOL if name == "flash_attention_stats" else ATTN_FWD_TOL
        check(e <= tol, "%s disagrees with its plain version at %s: %g > %g"
              % (name, tag, e, tol))
    return err, (out, lse), got4, stats_err


def _attn_check(ha, shape, gen, dev):
    """Kernels 3, 5 and 4 and the fused backward against their plain
    versions at one shape, each bit-equal on a rerun; returns (errors,
    inputs)."""
    B, H, Tq, Tk, D, causal = shape
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    q, k, v, do = r(B, H, Tq, D), r(B, H, Tk, D), r(B, H, Tk, D), \
        r(B, H, Tq, D)
    sc = 1.0 / math.sqrt(D)
    err, (out, lse), _, _ = _fwd_check(ha, q, k, v, causal, sc, shape)
    delta = (do * out).sum(-1)
    bargs = (q, k, v, do, lse, delta, causal, sc)
    dq, dk, dv = ha.flash_bwd(*bargs)
    again = ha.flash_bwd(*bargs)
    want = ha.flash_bwd_plain(*bargs)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
          "the fused backward is not bit-equal on a rerun at %s" % (shape,))
    rel = lambda g, w: ((g - w).abs().max() / w.abs().max()).item()  # noqa
    err.update(flash_dq=rel(dq, want[0]),
               flash_dkv=max(rel(dk, want[1]), rel(dv, want[2])))
    print("[attn-kernels] B=%d H=%d Tq=%d Tk=%d D=%d %s: kernel 3 %.3g, "
          "kernel 5 %.3g (out and lse, abs, tol %g), kernel 4 %.3g (tol %g);"
          " fused backward dq %.3g, dk and dv %.3g (of max |value|, tol %g);"
          " all bit-equal on a rerun"
          % (B, H, Tq, Tk, D, "causal" if causal else "non-causal",
             err["flash_fwd"], err["flash_fwd_lse"], ATTN_FWD_TOL,
             err["flash_attention_stats"], STATS_TOL,
             err["flash_dq"], err["flash_dkv"], ATTN_BWD_TOL))
    for name in ("flash_dq", "flash_dkv"):
        check(err[name] <= ATTN_BWD_TOL, "%s disagrees with its plain version"
              " at %s: %g > %g of max |value|" % (name, shape, err[name],
                                                   ATTN_BWD_TOL))
    return err, bargs


# kernels 6 and 7 before they were fused (two kernels that each recomputed
# s and dp), ms over a gpt2-small step's 12 calls on an H100 SXM at 700 W
# (PERF.md section 6): quoted beside the fused kernel, read by a print only
BEFORE_K67_MS = {"flash_dq": 16.53, "flash_dkv": 20.56}
# kernels 3, 5 and 4 before the forward's redesign (4 x 4 register tiles,
# K and V loaded between barriers): the last run of this script before it
# on "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md section 6), ms over an eval
# forward's / a training step's 12 gpt2-small calls, and a call of the
# ring's full and diagonal per-shard shapes; quoted beside this run's
# times, read by prints only
BEFORE_K345_MS = {"flash_fwd": 12.03, "flash_fwd_lse": 12.10,
                  "full": 1.7306, "diag": 1.0361}
# the fused backward's counter behind each ``kernels`` entry it serves
_COUNTER_OF = {"flash_dq": "flash_bwd", "flash_dkv": "flash_bwd"}


def _occupancy(lib, D):
    """CTAs an SM holds at head dim ``D`` of ``csrc/<lib>.cu``'s kernel, by
    its ``mxtt_<lib>_occupancy`` (the forward's: the least of its three
    epilogues)."""
    import ctypes
    from mxnet_tpu_torch import _build
    fn = getattr(_build.load(lib), "mxtt_%s_occupancy" % lib)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    blocks = ctypes.c_int(0)
    check(fn(D, 0, ctypes.byref(blocks)) == 0, "occupancy query failed")
    return blocks.value


def _bwd_split(ha, args, n=5):
    """ms a call of the fused backward's kernel and of its dq sum, from
    ``n`` profiled calls; and the launches of one call, counted."""
    kernels, _ = profiled_kernels(lambda: ha.flash_bwd(*args), n)
    split = {"kernel_ms": 0.0, "dq_sum_ms": 0.0}
    for e in kernels:
        key = ("dq_sum_ms" if "dq_sum_kernel" in e.name else "kernel_ms"
               if "flash_bwd_kernel" in e.name else None)
        if key:
            split[key] += e.time_range.elapsed_us() / n / 1e3
    before = (ha.flash_bwd_launches, ha.flash_dq_sum_launches)
    ha.flash_bwd(*args)
    split["launches_a_call"] = (ha.flash_bwd_launches - before[0],
                                ha.flash_dq_sum_launches - before[1])
    check(split["launches_a_call"] == (1, 1), "one flash_bwd call launched "
          "%s (fused kernel, dq sum), expected (1, 1)"
          % (split["launches_a_call"],))
    return split


def phase_attn_kernels(card):
    """Kernels 3 and 5 and the fused backward against their plain versions
    at the six shapes of ``ATTN_SHAPES`` and the fused kernel's occupancy,
    then, at the main path's (B=16, H=12, T=1024, D=64, causal, fp32), each
    kernel's time, TFLOP/s and bound beside its plain version's and the
    yardstick's: ``F.scaled_dot_product_attention`` (is_causal, fp32, TF32
    off) forward, and its backward (dq, dk and dv together) for the fused
    backward, whose time is split between its kernel and its dq sum.
    Returns the four ``kernels`` entries (without ``launches``): those of
    TPU kernels 6 (``flash_dq``) and 7 (``flash_dkv``) both name the fused
    backward."""
    from mxnet_tpu_torch.ops import hopper_attention as ha
    fp32_exact()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    errs = {}
    for shape in ATTN_SHAPES[1:] + ATTN_SHAPES[:1]:
        err, bargs = _attn_check(ha, shape, gen, dev)
        for k, e in err.items():
            errs[k] = max(errs.get(k, 0.0), e)
    occupancy = {D: _occupancy("flash_attn_bwd", D) for D in ha.SUPPORTED_D}
    print("[attn-kernels] fused backward: blocks an SM holds by head dim %s "
          "(the design assumes 1)" % occupancy)
    check(all(b >= 1 for b in occupancy.values()), "the fused backward does "
          "not fit an SM: %s" % occupancy)
    fwd_occupancy = {D: _occupancy("flash_attn_fwd", D)
                     for D in ha.SUPPORTED_D}
    plans = {D: ha.flash_fwd_plan(1024, 1024, D, True)
             for D in ha.SUPPORTED_D}
    print("[attn-kernels] forward (kernels 3, 4, 5): CTAs an SM holds by "
          "head dim %s (the design assumes 3 at D 64); plan tile (query rows,"
          " keys) and shared memory %s" % (fwd_occupancy, {
              D: (p.bq, p.bk, p.smem) for D, p in plans.items()}))
    check(all(b >= 1 for b in fwd_occupancy.values()), "the forward does "
          "not fit an SM: %s" % fwd_occupancy)
    q, k, v, do, lse, delta, causal, sc = bargs
    B, H, Tq, Tk, D, _ = ATTN_SHAPES[0]
    costs = _attn_costs(*ATTN_SHAPES[0])
    ms = {"flash_fwd": time_ms(lambda: ha.flash_fwd(q, k, v, causal, sc)),
          "flash_fwd_lse": time_ms(lambda: ha.flash_fwd_lse(q, k, v, causal,
                                                           sc)),
          "flash_bwd": time_ms(lambda: ha.flash_bwd(*bargs))}
    split = _bwd_split(ha, bargs)
    plain_fwd = time_ms(lambda: ha.flash_fwd_plain(q, k, v, causal, sc))
    plain_bwd = time_ms(lambda: ha.flash_bwd_plain(*bargs))
    plain = {"flash_fwd": plain_fwd, "flash_fwd_lse": plain_fwd,
             "flash_bwd": plain_bwd}
    # the yardstick: PyTorch's fused attention, never called by the port
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(  # noqa: E731
        a, b, c, is_causal=True)
    with torch.no_grad():
        lib_fwd = time_ms(lambda: sdpa(q, k, v))
        lib_err = (sdpa(q, k, v) - ha.flash_fwd(q, k, v, True, sc)) \
            .abs().max().item()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    lib_train_fwd = time_ms(lambda: sdpa(qg, kg, vg))
    out = sdpa(qg, kg, vg)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                  retain_graph=True))
    library = {"flash_fwd": lib_fwd, "flash_fwd_lse": lib_train_fwd,
               "flash_bwd": lib_bwd}
    bwd_lib = ("backward of F.scaled_dot_product_attention: dq, dk and dv "
               "together")
    meta = {
        "flash_fwd": ("mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
                      "mxnet_tpu/ops/pallas_attention.py:113", "kernel 3",
                      "F.scaled_dot_product_attention forward, no grad"),
        "flash_fwd_lse": ("mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
                          "mxnet_tpu/ops/pallas_attention.py:238", "kernel 5",
                          "F.scaled_dot_product_attention forward of "
                          "inputs that need grad (saves its logsumexp)"),
        "flash_dq": ("mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
                     "mxnet_tpu/ops/pallas_attention.py:276",
                     "kernel 6 (fused with 7)", bwd_lib),
        "flash_dkv": ("mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
                      "mxnet_tpu/ops/pallas_attention.py:315",
                      "kernel 7 (fused with 6)", bwd_lib)}
    entries = []
    for name, (source, replaces, label, lib_what) in meta.items():
        key = _COUNTER_OF.get(name, name)
        flops, nbytes = costs[key]
        bound, by = _bound(flops, nbytes)
        call_ms = ms[key]
        print("[attn-kernels] %s (%s) at B=%d H=%d T=%d D=%d causal fp32: "
              "%.4f ms (%.2f TFLOP/s), bound %.4f ms (%s), plain %.4f ms, "
              "library %.4f ms (%s)" % (label, name, B, H, Tq, D, call_ms,
                                        flops / call_ms / 1e9, bound, by,
                                        plain[key], library[key], lib_what))
        calls = TFM_LAYERS
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": errs[name],
            "max_err_is": ("absolute, out and lse" if name.startswith(
                "flash_fwd") else "of max |value|"),
            "B": B, "H": H, "T": Tq, "D": D, "causal": True,
            "calls_per_step": calls,
            "per_step_is": ("an eval forward" if name == "flash_fwd"
                            else "a training step"),
            "call_ms": call_ms, "call_plain_ms": plain[key],
            "call_bound_ms": bound, "call_library_ms": library[key],
            "ms": call_ms * calls, "plain_ms": plain[key] * calls,
            "bound_ms": bound * calls, "bound_by": by,
            "library_ms": library[key] * calls, "library": lib_what,
            "tflops": flops / call_ms / 1e9, "gflop_per_call": flops / 1e9}
        if key == "flash_bwd":
            entry.update(fused="one launch computes dq, dk and dv for both "
                         "TPU kernels 6 and 7, then a fixed-order dq sum",
                         kernel_ms=split["kernel_ms"] * calls,
                         dq_sum_ms=split["dq_sum_ms"] * calls,
                         occupancy=occupancy)
        else:
            entry.update(occupancy=fwd_occupancy)
            print("[attn-kernels] %s over %s's %d calls: %.3f ms, SDPA %.3f "
                  "ms; before the redesign %.2f ms (the last run before it, "
                  "quoted)" % (label, entry["per_step_is"], calls,
                               entry["ms"], entry["library_ms"],
                               BEFORE_K345_MS[name]))
        entries.append(entry)
    print("[attn-kernels] fused backward over a step's %d calls: %.3f ms "
          "(kernel %.3f, dq sum %.3f; %s launches a call), bound %.3f ms at "
          "five products (%.1f GFLOP a call), SDPA backward %.3f ms; "
          "kernels 6 + 7 before the fusion %.2f + %.2f ms (PERF.md, quoted)"
          % (TFM_LAYERS, ms["flash_bwd"] * TFM_LAYERS,
             split["kernel_ms"] * TFM_LAYERS, split["dq_sum_ms"] * TFM_LAYERS,
             split["launches_a_call"], _bound(*costs["flash_bwd"])[0]
             * TFM_LAYERS, costs["flash_bwd"][0] / 1e9,
             lib_bwd * TFM_LAYERS, BEFORE_K67_MS["flash_dq"],
             BEFORE_K67_MS["flash_dkv"]))
    print("[attn-kernels] SDPA (fp32, TF32 off) forward %.4f ms, with grad "
          "%.4f ms, backward %.4f ms; its output within %.3g of kernel 3's "
          "on %s" % (lib_fwd, lib_train_fwd, lib_bwd, lib_err, card))
    del q, k, v, do, lse, delta, qg, kg, vg, out
    return entries


TFM_LAYERS = 12         # gpt2-small's, all kept (nothing cut)


def tfm_module(ctx, batch, n_layers=None, arg_params=None):
    """``bench.py --transformer``'s Module (bench.py:710-722) on ``ctx``:
    ``transformer_lm(gpt2-small)`` bound at (batch, 1024),
    ``Xavier(gaussian, 2)`` after ``random.seed(7)`` (or ``arg_params``),
    SGD lr 0.05 momentum 0.9 through ``kvstore='local'``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import get_config, transformer_lm
    over = {} if n_layers is None else {"n_layers": n_layers}
    cfg = get_config(TFM["config"], **over)
    mod = mx.mod.Module(transformer_lm(cfg), data_names=("data",),
                        label_names=("softmax_label",), context=[ctx])
    mod.bind(data_shapes=[("data", (batch, cfg.seq_len))],
             label_shapes=[("softmax_label", (batch, cfg.seq_len))])
    if arg_params is None:
        mx.random.seed(TFM["init_seed"])
        mod.init_params(mx.init.Xavier(rnd_type="gaussian", magnitude=2.0))
    else:
        mod.init_params(initializer=None, arg_params=arg_params)
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate": TFM["lr"],
                                         "momentum": TFM["momentum"]})
    it = mx.io.SyntheticLMIter(cfg.vocab_size, cfg.seq_len, batch_size=batch,
                               num_batches=TFM["num_batches"],
                               seed=TFM["data_seed"], ctx=ctx)
    return cfg, mod, it


def _next_batch(it):
    try:
        return next(it)
    except StopIteration:
        it.reset()
        return next(it)


def _attn_counts(ha):
    return {"flash_fwd": ha.flash_fwd_launches,
            "flash_fwd_lse": ha.flash_fwd_lse_launches,
            "flash_bwd": ha.flash_bwd_launches,
            "flash_dq_sum": ha.flash_dq_sum_launches}


def _zero_attn_counts(ha):
    ha.flash_fwd_launches = ha.flash_fwd_lse_launches = 0
    ha.flash_bwd_launches = ha.flash_dq_sum_launches = 0


def phase_tfm_training(card):
    """Train bench.py's transformer LM at full width and depth on gpu(0)
    through the port's Module and its fused step: launch counts every step,
    finite losses, train tokens/s and MFU; then one eval forward."""
    from mxnet_tpu_torch import fused_step, gpu
    from mxnet_tpu_torch.ops import hopper_attention as ha
    fp32_exact()
    torch.cuda.empty_cache()
    check(fused_step.enabled(), "MXNET_TPU_FUSED_STEP turns the fused step "
          "off; the main path is the fused step")
    t0 = time.perf_counter()
    cfg, mod, it = tfm_module(gpu(0), TFM["batch"])
    n_params = sum(int(np.prod(a.shape)) for a in mod.get_params()[0]
                   .values())
    print("[tfm-training] %s: vocab %d, %d layers, d_model %d, %d heads, "
          "d_ff %d, seq_len %d; %d parameters (%d by n_params()), bound and "
          "initialized on gpu(0) in %.2f s"
          % (cfg.name, cfg.vocab_size, cfg.n_layers, cfg.d_model, cfg.n_heads,
             cfg.d_ff, cfg.seq_len, n_params, cfg.n_params(),
             time.perf_counter() - t0))
    tokens = TFM["batch"] * cfg.seq_len
    want = {"flash_fwd": 0, "flash_fwd_lse": cfg.n_layers,
            "flash_bwd": cfg.n_layers, "flash_dq_sum": cfg.n_layers}

    # the main path: counts zeroed just before the first step, read after
    # each step and after the last
    _zero_attn_counts(ha)
    losses, times, prev = [], [], _attn_counts(ha)
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        batch = _next_batch(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        loss = mod.get_outputs()[0]
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            times.append(time.perf_counter() - t0)
        losses.append(float(loss.asnumpy().ravel()[0]))
        now = _attn_counts(ha)
        step = {k: now[k] - prev[k] for k in now}
        check(step == want, "step %d launched %s, expected %s" % (i, step,
                                                                  want))
        prev = now
    launches = _attn_counts(ha)
    steps = len(losses)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("[tfm-training] %d steps ran %s launches (expected per step %s)"
          % (steps, launches, want))
    check(all(math.isfinite(v) for v in losses), "non-finite loss: %s"
          % losses)
    step_ms = float(np.median(times)) * 1e3
    tps = tokens / (step_ms / 1e3)
    mfu = cfg.flops_per_token() * tps / PEAK_FP32
    print("[tfm-training] batch %d x %d tokens, fp32: %d timed steps after "
          "%d warm-up, median %.2f ms (min %.2f, max %.2f), %.1f train "
          "tokens/s, MFU %.4f (flops_per_token %.4g x tokens/s over 67 "
          "TFLOP/s fp32), peak memory %.2f GB on %s; losses %s"
          % (TFM["batch"], cfg.seq_len, TIMED_STEPS, WARMUP_STEPS, step_ms,
             min(times) * 1e3, max(times) * 1e3, tps, mfu,
             cfg.flops_per_token(), peak_gb, card,
             ["%.4f" % v for v in losses]))

    # eval: one forward of the same Module, counts zeroed just before
    batch = _next_batch(it)
    _zero_attn_counts(ha)
    mod.forward(batch, is_train=False)
    eval_loss = float(mod.get_outputs()[0].asnumpy().ravel()[0])
    eval_launches = _attn_counts(ha)
    want_eval = {"flash_fwd": cfg.n_layers, "flash_fwd_lse": 0,
                 "flash_bwd": 0, "flash_dq_sum": 0}
    print("[tfm-training] eval forward: loss %.4f, launches %s (expected %s)"
          % (eval_loss, eval_launches, want_eval))
    check(eval_launches == want_eval, "the eval forward launched %s, "
          "expected %s" % (eval_launches, want_eval))
    check(math.isfinite(eval_loss), "non-finite eval loss %g" % eval_loss)
    launches["flash_fwd"] = eval_launches["flash_fwd"]
    return launches, {
        "tokens_per_s": tps, "mfu": mfu, "step_ms": step_ms,
        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
        "steps": steps, "losses": losses, "eval_loss": eval_loss,
        "peak_memory_gb": peak_gb, "n_params": n_params,
        "flops_per_token": cfg.flops_per_token(),
        "config": dict(TFM, dtype="float32", seq_len=cfg.seq_len,
                       n_layers=cfg.n_layers)}, (mod, it)


def phase_tfm_vs_cpu(card):
    """The first step of the full-width transformer at batch 1 on the card
    and on the CPU (plain versions), from the same weights and batch: the
    loss within rtol 1e-4 and every parameter's update within 1% of its
    norm.  Depth is cut to 4 layers only if the CPU step takes over 60 s
    at full depth."""
    from mxnet_tpu_torch import cpu, gpu
    fp32_exact()
    torch.cuda.empty_cache()
    n_layers = TFM_LAYERS
    while True:
        _, gmod, git = tfm_module(gpu(0), 1, n_layers)
        w_init = {k: v.asnumpy() for k, v in gmod.get_params()[0].items()}
        batch = next(git)
        gmod.forward_backward(batch)
        gmod.update()
        loss = float(gmod.get_outputs()[0].asnumpy().ravel()[0])
        w_gpu = {k: v.asnumpy() for k, v in gmod.get_params()[0].items()}
        del gmod
        torch.cuda.empty_cache()
        _, cmod, cit = tfm_module(cpu(), 1, n_layers, arg_params=w_init)
        t0 = time.perf_counter()
        cmod.forward_backward(next(cit))
        cmod.update()
        closs = float(cmod.get_outputs()[0].asnumpy().ravel()[0])
        cpu_s = time.perf_counter() - t0
        if cpu_s <= TFM_CPU_STEP_LIMIT_S or n_layers == 4:
            break
        print("[tfm-vs-cpu] the CPU step took %.1f s at %d layers; cutting "
              "depth to 4" % (cpu_s, n_layers))
        n_layers = 4
    w_cpu = {k: v.asnumpy() for k, v in cmod.get_params()[0].items()}
    rel_loss = abs(loss - closs) / abs(closs)
    worst, worst_name = 0.0, None
    for k in w_init:
        want = w_cpu[k] - w_init[k]
        got = w_gpu[k] - w_init[k]
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        if err > worst:
            worst, worst_name = err, k
    print("[tfm-vs-cpu] first step at batch 1, T=1024, %d layers, vs the CPU "
          "(plain versions, %.1f s): loss %.6f vs %.6f (rel %.3g, tol %g); "
          "every update within %.3g of its norm (tol %g; largest: %s)"
          % (n_layers, cpu_s, loss, closs, rel_loss, LOSS_RTOL, worst,
             TFM_UPDATE_TOL, worst_name))
    check(rel_loss <= LOSS_RTOL, "first-step loss differs from the CPU by "
          "%g > %g" % (rel_loss, LOSS_RTOL))
    check(worst <= TFM_UPDATE_TOL, "the update of %s differs from the CPU's "
          "by %g > %g of its norm" % (worst_name, worst, TFM_UPDATE_TOL))
    return {"n_layers": n_layers, "loss": loss, "cpu_loss": closs,
            "loss_rel_err": rel_loss, "update_rel_err_max": worst,
            "update_rel_err_max_param": worst_name, "cpu_step_s": cpu_s}


_FWD_MODE = re.compile(r"flash_fwd_kernel(?:<\d+, (\d)>|ILi\d+ELi(\d)E)")
_FWD_GROUPS = {"0": "kernel 3 (flash_fwd)", "1": "kernel 5 (flash_fwd_lse)",
               "2": "kernel 4 (flash_attention_stats)"}
BWD_GROUP = "kernels 6+7 (flash_bwd_kernel, fused)"
DQ_SUM_GROUP = "kernels 6+7 dq sum (dq_sum_kernel)"


def _tfm_group(name: str) -> str:
    lname = name.lower()
    if "flash_fwd_kernel" in name:
        # flash_fwd_kernel<D, MODE>, demangled or not
        mode = _FWD_MODE.search(name)
        check(mode is not None, "unknown flash forward kernel %s" % name)
        return _FWD_GROUPS[mode.group(1) or mode.group(2)]
    if "flash_bwd_kernel" in name:
        return BWD_GROUP
    if "dq_sum_kernel" in name:
        return DQ_SUM_GROUP
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    if "multi_tensor_apply" in lname or "foreach" in lname:
        return "optimizer (foreach SGD)"
    if any(k in lname for k in ("gemm", "xmma", "cutlass", "sm80_", "sm90_",
                                "nvjet", "splitk")):
        return "cuBLAS (QKV/O, FFN, LM head)"
    if any(k in lname for k in ("logsumexp", "softmax", "gather", "scatter",
                                "log_", "exp")):
        return "cross-entropy"
    if "embedding" in lname or "indexing_backward" in lname \
            or "radix" in lname or "sort" in lname:
        return "embedding"
    return "LayerNorm, gelu and elementwise"


def phase_tfm_profile(card, trained, step_ms):
    """One profiled training step: device time and launches by group, the
    launches of the four attention kernels read from the trace, and the
    device's idle share against the unprofiled median step."""
    mod, it = trained
    batch = _next_batch(it)

    def step():
        mod.forward_backward(batch)
        mod.update()
        mod.get_outputs()[0].wait_to_read()

    kernels, wall_ms = profiled_kernels(step, 1, "tfm-profile")
    groups, counts, by_name = {}, {}, {}
    for e in kernels:
        g = _tfm_group(e.name)
        us = e.time_range.elapsed_us()
        groups[g] = groups.get(g, 0.0) + us
        counts[g] = counts.get(g, 0) + 1
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    device_ms = sum(groups.values()) / 1e3
    check(device_ms > 0, "the profiler recorded no device time")
    traced = tuple(counts.get(g, 0) for g in (
        "kernel 3 (flash_fwd)", "kernel 5 (flash_fwd_lse)", BWD_GROUP,
        DQ_SUM_GROUP))
    check(traced == (0, TFM_LAYERS, TFM_LAYERS, TFM_LAYERS), "profile saw "
          "kernels 3, 5, the fused backward and its dq sum launched %s times "
          "in one step" % (traced,))
    idle = max(0.0, 1 - device_ms / step_ms)
    print("[tfm-profile] one step: %.2f ms device busy, %.2f ms wall "
          "unprofiled (%.1f%% idle), %.2f ms wall profiled; %d launches on "
          "%s" % (device_ms, step_ms, 100 * idle, wall_ms, len(kernels),
                  card))
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[tfm-profile]   %-36s %8.3f ms/step (%.1f%%), %4d launches"
              % (g, us / 1e3, 100.0 * us / 1e3 / device_ms, counts[g]))
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print("[tfm-profile]   top: %7.3f ms/step, %3d launches  %s [%s]"
              % (us / 1e3, n, name[:80], _tfm_group(name)))
    return {"step_device_ms": device_ms, "idle_share": idle,
            "step_wall_ms_profiled": wall_ms, "launches_per_step":
            len(kernels), "device_ms_by_group": {g: us / 1e3 for g, us in
                                                 groups.items()},
            "launches_by_group": counts}


# --------------------------------------------------------------------------
def resnet_params(arg_names, arg_shapes, aux_names, aux_shapes, seed):
    """Seeded weights that keep a random pre-activation ResNet-50's
    activations near unit scale (He-normal convs, the last conv of each
    residual branch scaled down, logits a few units wide) with positive
    moving variances, under the checkpoint's arg:/aux: prefixes."""
    r = np.random.default_rng(seed)
    out = {}
    for n, s in zip(arg_names, arg_shapes):
        if n == "data":
            continue
        if n.endswith("_weight") and len(s) == 4:
            v = r.standard_normal(s) * math.sqrt(2.0 / np.prod(s[1:]))
            if n.endswith("_conv3_weight"):
                v *= 0.2
        elif n.endswith("_weight"):
            v = r.standard_normal(s) / math.sqrt(s[1])
        elif n.endswith("_gamma"):
            v = r.uniform(0.8, 1.2, s)
        else:                                  # betas and biases
            v = r.standard_normal(s) * 0.05
        out["arg:" + n] = v.astype(np.float32)
    for n, s in zip(aux_names, aux_shapes):
        v = (r.uniform(0.5, 1.5, s) if n.endswith("_moving_var")
             else r.standard_normal(s) * 0.05)
        out["aux:" + n] = v.astype(np.float32)
    return out


def resnet50_probs(seed=SEED):
    """The served graph, full-width ResNet-50's softmax over ``fc1_output``,
    and its seeded weights."""
    from mxnet_tpu_torch import sym
    from mxnet_tpu_torch.models import resnet
    net = resnet.get_symbol(num_classes=1000, num_layers=50)
    probs = sym.softmax(net.get_internals()["fc1_output"], axis=1)
    args, outs, auxs = probs.infer_shape(data=(1, 3, 224, 224))
    check(outs == [(1, 1000)], "ResNet-50 output shape %s" % outs)
    params = resnet_params(probs.list_arguments(), args,
                           probs.list_auxiliary_states(), auxs, seed)
    return probs, params


def _check_served(got, want, what):
    """A served answer against the CPU's: same shape, finite, same top-1,
    probabilities within PROB_TOL; returns the max |dp|."""
    check(got.shape == want.shape and np.isfinite(got).all(),
          "%s: bad answer shape %s" % (what, got.shape))
    check((got.argmax(1) == want.argmax(1)).all(),
          "%s: top-1 differs from the CPU run" % what)
    worst = float(np.abs(got - want).max())
    check(worst <= PROB_TOL, "%s: probabilities differ by %g > %g"
          % (what, worst, PROB_TOL))
    return worst


def _small_model():
    """A small MLP (data (n, 32) -> FC 64, relu, FC 10, softmax) and its
    seeded weights: the registry's second model."""
    from mxnet_tpu_torch import sym
    h = sym.Activation(sym.FullyConnected(sym.var("data"), num_hidden=64,
                                          name="fc1"), act_type="relu")
    net = sym.softmax(sym.FullyConnected(h, num_hidden=10, name="fc2"),
                      axis=1)
    r = np.random.default_rng(SEED + 5)
    params = {"arg:fc1_weight": r.standard_normal((64, 32)) / math.sqrt(32),
              "arg:fc1_bias": r.standard_normal(64) * 0.1,
              "arg:fc2_weight": r.standard_normal((10, 64)) / 8.0,
              "arg:fc2_bias": r.standard_normal(10) * 0.1}
    return net, {k: v.astype(np.float32) for k, v in params.items()}


def _post_json(port, doc):
    import urllib.request
    req = urllib.request.Request(
        "http://127.0.0.1:%d/predict" % port, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def phase_gateway(card, probs, params, new_params, images, ref):
    """Phase 3's gateway: a ``ModelRegistry`` of the full-width ResNet-50
    (buckets up to 4) and a small MLP on gpu(0), routed by name, and the
    HTTP endpoint on 127.0.0.1 port 0 answering one POST for each model;
    every answer against the CPU's.  Then a swap of ResNet-50's weights
    through the registry, answered against the CPU on the new weights."""
    from mxnet_tpu_torch import cpu, gpu, serving
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.weights import from_jax_params
    mlp, mlp_params = _small_model()
    x = np.random.default_rng(SEED + 6).standard_normal((3, 32)) \
        .astype(np.float32)
    mlp_ref = Predictor(mlp.tojson(), from_jax_params(mlp_params, cpu()),
                        ctx=cpu(), input_shapes={"data": x.shape}) \
        .forward(data=x)[0].asnumpy()
    reg = serving.ModelRegistry()
    t0 = time.perf_counter()
    try:
        reg.register("resnet50", probs.tojson(),
                     from_jax_params(params, gpu(0)), {"data": (3, 224, 224)},
                     ctx=gpu(0), max_batch_size=4, batch_timeout_ms=2.0)
        reg.register("mlp", mlp.tojson(), from_jax_params(mlp_params, gpu(0)),
                     {"data": (32,)}, ctx=gpu(0), max_batch_size=4)
        setup_s = time.perf_counter() - t0
        check(reg.models() == ["mlp", "resnet50"], "registry holds %s"
              % reg.models())
        worst = max(
            _check_served(reg.predict({"data": images[:2]},
                                      model="resnet50")[0], ref[:2],
                          "registry resnet50"),
            _check_served(reg.predict({"data": x}, model="mlp")[0], mlp_ref,
                          "registry mlp"))
        port = serving.start_http_server(reg, host="127.0.0.1", port=0)
        try:
            status, doc = _post_json(port, {"inputs": {
                "data": images[2:3].tolist()}, "model": "resnet50"})
            check(status == 200 and doc["rows"] == 1, "HTTP resnet50: %d"
                  % status)
            http_worst = _check_served(np.array(doc["outputs"][0],
                                                np.float32), ref[2:3],
                                       "HTTP resnet50")
            status, doc = _post_json(port, {"inputs": {"data": x.tolist()},
                                            "model": "mlp"})
            check(status == 200 and doc["rows"] == 3, "HTTP mlp: %d" % status)
            http_worst = max(http_worst, _check_served(
                np.array(doc["outputs"][0], np.float32), mlp_ref, "HTTP mlp"))
        finally:
            serving.stop_http_server()
        reg.swap_params("resnet50", new_params)
        new_ref = Predictor(
            probs.tojson(), from_jax_params(new_params, cpu()), ctx=cpu(),
            input_shapes={"data": (1, 3, 224, 224)}).forward(
                data=images[:1])[0].asnumpy()
        swapped = _check_served(reg.predict({"data": images[:1]},
                                            model="resnet50")[0], new_ref,
                                "registry resnet50 after its swap")
        health = reg.health()
        check(health["status"] == "serving", "registry health %s" % health)
    finally:
        reg.stop_all()
    print("[gateway] ModelRegistry of resnet50 (buckets 1-4) and mlp built "
          "and warmed in %.2f s; routed answers match the CPU (max |dp| "
          "%.3g), HTTP on 127.0.0.1:%d answers both (max |dp| %.3g), a swap "
          "through the registry answers as the CPU on the new weights (max "
          "|dp| %.3g) on %s" % (setup_s, worst, port, http_worst, swapped,
                                card))
    return {"registry_setup_s": setup_s, "max_dp": worst,
            "http_max_dp": http_worst, "swap_max_dp": swapped}


def phase_serving(card):
    """Serve full-width ResNet-50 on gpu(0); returns (launches, summary)."""
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.ops import hopper_conv as hc
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.weights import from_jax_params
    fp32_exact()

    probs, params = resnet50_probs()
    print("[serving] ResNet-50: %d parameters, %d aux states" % (
        sum(v.size for k, v in params.items() if k.startswith("arg:")),
        sum(k.startswith("aux:") for k in params)))
    js = probs.tojson()

    server = ModelServer(js, from_jax_params(params, gpu(0)),
                         {"data": (3, 224, 224)}, ctx=gpu(0),
                         max_batch_size=BATCH, batch_timeout_ms=5.0)
    server.start()
    print("[serving] buckets %s warmed up in %.2f s"
          % (server.stats()["buckets"], server.warmup_seconds))

    rng = np.random.default_rng(SEED + 1)
    rows = [1, 3, 8, 2, 5, 4, 7, 6]
    classes = ["realtime", "standard", "batch"]
    images = rng.standard_normal((sum(rows), 3, 224, 224)).astype(np.float32)
    offsets = np.cumsum([0] + rows)
    # the weights swapped in halfway through the closed loop
    _, new_params = resnet50_probs(SEED + 3)
    executed = []
    execute = server._execute

    def recording_execute(live):
        executed.append(list(live))
        execute(live)

    server._execute = recording_execute

    def burst(n_clients, per_client, make_request, midway=None):
        """n_clients threads, each submitting per_client requests in turn;
        returns [(client, i, latency_s, outputs, request)] and the wall
        seconds.  ``midway`` runs once half the requests are answered."""
        results, errors = [], []
        lock = threading.Lock()
        go = threading.Barrier(n_clients + 1)

        def client(c):
            go.wait()
            try:
                for i in range(per_client):
                    inputs, slo = make_request(c, i)
                    t0 = time.perf_counter()
                    req = server.submit(inputs, slo_class=slo)
                    out = req.result(300)
                    with lock:
                        results.append((c, i, time.perf_counter() - t0, out,
                                        req))
            except Exception as e:  # noqa: BLE001 - reported below
                with lock:
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        go.wait()
        t0 = time.perf_counter()
        if midway is not None:
            half = n_clients * per_client // 2
            while len(results) < half and not errors and any(
                    t.is_alive() for t in threads):
                time.sleep(0.001)
            midway()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        check(not errors, "requests failed: %s" % errors[:3])
        check(not any(t.is_alive() for t in threads), "clients hung")
        return results, wall

    # the main path: counts zeroed just before, read just after; each
    # kernel-1 call's shape is noted (the bucket a batch ran at sets how its
    # plans split the reduction)
    conv_calls = []
    real_conv = hc._taps_conv_cuda

    def noted_conv(x, taps, pads, KH, KW, stride=1, **kw):
        conv_calls.append((tuple(x.shape), taps.shape[2], pads, KH, KW,
                           stride))
        return real_conv(x, taps, pads, KH, KW, stride, **kw)
    hc._taps_conv_cuda = noted_conv
    hc.launches = hc.conv_reduce_launches = 0
    batches0 = server.batches
    answers, wall = burst(len(rows), 1, lambda c, i: (
        {"data": images[offsets[c]:offsets[c + 1]]}, classes[c % 3]))
    loop_rows, n_clients, per_client = 8, 8, 8
    loop_img = rng.standard_normal((loop_rows, 3, 224, 224)) \
        .astype(np.float32)
    swap_s = []

    def swap():
        t0 = time.perf_counter()
        server.swap_params(from_jax_params(new_params, gpu(0)))
        swap_s.append(time.perf_counter() - t0)

    loop, loop_wall = burst(n_clients, per_client, lambda c, i: (
        {"data": loop_img}, "standard"), midway=swap)
    launches, reductions = hc.launches, hc.conv_reduce_launches
    batches = server.batches - batches0
    hc._taps_conv_cuda = real_conv
    server.stop()
    sms = _sms(torch.device("cuda", 0))
    want_sums = 0
    for (N, H, W, C), O, pads, KH, KW, stride in conv_calls:
        Ho, Wo = hc._out_hw(H, W, KH, KW, pads, stride)
        want_sums += hc.conv_fp32_plan(N * Ho * Wo, C, O, KH, KW,
                                       sms).splits > 1
    print("[serving] %d forwards ran %d kernel launches (%.2f per forward) "
          "and %d split sums (%d by the plans of the calls' shapes)"
          % (batches, launches, launches / max(batches, 1), reductions,
             want_sums))
    check(batches > 0 and launches == 16 * batches == len(conv_calls),
          "expected 16 conv kernel launches per forward, got %d over %d "
          "forwards" % (launches, batches))
    check(reductions == want_sums, "the served forwards ran %d split sums of "
          "kernel 1, their plans %d" % (reductions, want_sums))
    launches += reductions

    lat = sorted(r[2] * 1e3 for r in answers)
    print("[serving] %d concurrent requests (%d images, rows %s, classes "
          "%s): latencies ms %s, %.1f images/s on %s" % (
              len(rows), sum(rows), rows, [classes[c % 3] for c in
                                           range(len(rows))],
              ["%.2f" % v for v in lat], sum(rows) / wall, card))
    loop_lat = np.array([r[2] * 1e3 for r in loop])
    loop_ips = n_clients * per_client * loop_rows / loop_wall
    print("[serving] closed loop, %d clients x %d requests of %d images, "
          "the weights swapped halfway (swap_params %.2f ms): %.1f images/s, "
          "latency p50 %.2f ms p99 %.2f ms on %s" % (
              n_clients, per_client, loop_rows, swap_s[0] * 1e3, loop_ips,
              np.percentile(loop_lat, 50), np.percentile(loop_lat, 99), card))

    # reference: the same graph and weights on the CPU (plain versions)
    t0 = time.perf_counter()
    ref_pred = Predictor(js, from_jax_params(params, cpu()), ctx=cpu(),
                         input_shapes={"data": images.shape})
    ref = ref_pred.forward(data=images)[0].asnumpy()
    loop_refs = [Predictor(js, from_jax_params(p, cpu()), ctx=cpu(),
                           input_shapes={"data": loop_img.shape})
                 .forward(data=loop_img)[0].asnumpy()
                 for p in (params, new_params)]
    print("[serving] CPU reference forwards of %d + 2 x %d images in %.2f s"
          % (len(images), loop_rows, time.perf_counter() - t0))
    worst = 0.0
    for c, _, _, out, _ in answers:
        worst = max(worst, _check_served(
            out[0], ref[offsets[c]:offsets[c + 1]], "request %d" % c))
    print("[serving] all %d answers match the CPU run: same top-1, max "
          "|dp| %.3g (tol %g), max p %.4f" % (len(answers), worst, PROB_TOL,
                                              float(ref.max())))
    # the hot swap: every answer is the CPU's on the old or the new weights,
    # and every request of one executed batch on the same set
    check(np.abs(loop_refs[0] - loop_refs[1]).max() > 100 * PROB_TOL,
          "the two weight sets give the same answers")
    weight_set, swap_worst = {}, 0.0
    for _, _, _, out, req in loop:
        errs = [float(np.abs(out[0] - r).max()) for r in loop_refs]
        k = int(np.argmin(errs))
        swap_worst = max(swap_worst, _check_served(
            out[0], loop_refs[k], "closed-loop request on weight set %d" % k))
        weight_set[id(req)] = k
    mixed = [b for b in executed if len({weight_set[id(r)] for r in b
                                         if id(r) in weight_set}) > 1]
    counts = [sum(v == k for v in weight_set.values()) for k in (0, 1)]
    print("[serving] hot swap: %d answers on the old weights and %d on the "
          "new, each matching the CPU on its set (max |dp| %.3g), %d "
          "batches, none mixing two sets" % (counts[0], counts[1],
                                             swap_worst, len(executed)))
    check(not mixed and min(counts) > 0, "the swap mixed weight sets in %d "
          "batches (answers per set %s)" % (len(mixed), counts))
    gateway = phase_gateway(card, probs, params, new_params, images, ref)
    return launches, {"images_per_s": loop_ips,
                      "latency_p50_ms": float(np.percentile(loop_lat, 50)),
                      "latency_p99_ms": float(np.percentile(loop_lat, 99)),
                      "swap_answers_per_set": counts, "gateway": gateway}


def _kernel_group(name: str) -> str:
    if "taps_conv_kernel" in name or "fp32_3x3_conv" in name:
        return "implicit_gemm_conv (port)"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    lname = name.lower()
    if any(k in lname for k in ("conv", "gemm", "xmma", "cudnn", "cutlass")):
        return "cuDNN/cuBLAS (7x7, 1x1, fc)"
    return "elementwise, pooling, layout"


def phase_profile(card):
    """Where a batch-32 forward's time goes: host wall per forward (H2D
    copy, forward, D2H copy, as the server runs it) against device busy
    time from torch.profiler, by kernel group."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.weights import from_jax_params
    fp32_exact()
    probs, params = resnet50_probs()
    shape = (BATCH, 3, 224, 224)
    pred = Predictor(probs.tojson(), from_jax_params(params, gpu(0)),
                     ctx=gpu(0), input_shapes={"data": shape})
    feed = np.random.default_rng(SEED + 2).standard_normal(shape) \
        .astype(np.float32)
    step = lambda: pred.forward(data=feed)[0].asnumpy()
    for _ in range(3):
        step()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
    groups, top = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        groups[_kernel_group(e.key)] = groups.get(_kernel_group(e.key),
                                                  0.0) + us
        top.append((us, e.count, e.key))
    device_ms = sum(groups.values()) / n / 1e3
    print("[profile] batch %d forward as served: %.2f ms wall, %.2f ms "
          "device busy (%.1f%% idle), %.1f images/s on %s" % (
              BATCH, wall_ms, device_ms,
              100.0 * max(0.0, 1 - device_ms / wall_ms),
              BATCH / wall_ms * 1e3, card))
    check(device_ms > 0, "the profiler recorded no device time")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[profile]   %-30s %7.3f ms/forward (%.1f%% of device time)"
              % (g, us / n / 1e3, 100.0 * us / n / 1e3 / device_ms))
    for us, count, key in sorted(top, reverse=True)[:8]:
        print("[profile]   top: %7.3f ms/forward, %4d launches/forward  %s"
              % (us / n / 1e3, count // n, key[:90]))
    return {"forward_wall_ms": wall_ms, "forward_device_ms": device_ms,
            "device_ms_by_group": {g: us / n / 1e3
                                   for g, us in groups.items()}}


# --------------------------------------------------------------------------
def gluon_resnet50(ctx, batch, hybridize=True):
    """Full-width Gluon ResNet-50 v1 on ``ctx`` with the weights that
    ``net.initialize()`` draws after ``random.seed(SEED)`` (Uniform(0.07)
    weights, BatchNorm at gamma 1, beta 0, moving mean 0 and variance 1),
    and one seeded batch: 224 px images from U[0, 1) and class labels as
    float32, as bench.py makes them; hybridized unless told."""
    from mxnet_tpu_torch import name, nd, random
    from mxnet_tpu_torch.gluon.model_zoo import vision
    random.seed(SEED)
    with name.NameManager():
        net = vision.resnet50_v1()
    net.initialize(ctx=ctx)
    if hybridize:
        net.hybridize()
    r = np.random.default_rng(SEED + 4)
    x = r.uniform(size=(batch, 3, 224, 224)).astype(np.float32)
    y = r.integers(0, 1000, (batch,)).astype(np.float32)
    return net, nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)


def wgrad_reductions_per_step(batch=BATCH, bf16=False):
    """Launches of kernel 2's reduction pass in one training step at
    ``batch``: one for each 3x3 convolution whose wgrad rows are split, by
    the fp32 kernel's plan or the bf16 kernel's."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = hc.wgrad_bf16_plan if bf16 else hc.wgrad_fp32_plan
    return sum(count for C, H, count in GLUON_3X3
               if plan(batch * H * H, C, C, 3, 3, sms).splits > 1)


def conv_reductions_per_step(batch=BATCH):
    """Launches of kernel 1 fp32's split sum in one training step at
    ``batch``: one for each of the 16 forwards and 16 dgrads (C = O, so one
    plan for both) whose reduction its plan splits."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sum(2 * count for C, H, count in GLUON_3X3
               if hc.conv_fp32_plan(batch * H * H, C, C, 3, 3, sms).splits > 1)


def _conv_counts(hc):
    """Kernels 1 and 2's launch counters, the fp32 kernels' apart from the
    bf16 ones."""
    return {"implicit_gemm_conv": hc.launches - hc.launches_bf16,
            "implicit_gemm_conv reduction": hc.conv_reduce_launches,
            "taps_conv_bf16": hc.launches_bf16,
            "taps_wgrad": hc.wgrad_launches - hc.wgrad_launches_bf16,
            "taps_wgrad reduction": (hc.wgrad_reduce_launches
                                     - hc.wgrad_reduce_launches_bf16),
            "taps_wgrad_bf16": hc.wgrad_launches_bf16,
            "taps_wgrad_bf16 reduction": hc.wgrad_reduce_launches_bf16}


def _zero_conv_counts(hc):
    hc.launches = hc.launches_bf16 = hc.conv_reduce_launches = 0
    hc.wgrad_launches = hc.wgrad_reduce_launches = 0
    hc.wgrad_launches_bf16 = hc.wgrad_reduce_launches_bf16 = 0


def bf16_step_counts(batch=BF16_BATCH):
    """Kernels 1 and 2's launches in one bf16 training step: every 3x3 on
    the bf16 kernels (16 forwards and 16 dgrads, 16 wgrads and the plan's
    reductions), none on the fp32 ones."""
    return {"implicit_gemm_conv": 0, "implicit_gemm_conv reduction": 0,
            "taps_conv_bf16": 32, "taps_wgrad": 0,
            "taps_wgrad reduction": 0, "taps_wgrad_bf16": 16,
            "taps_wgrad_bf16 reduction": wgrad_reductions_per_step(batch,
                                                                   True)}


def w1x1_reductions_per_step(batch=BF16_BATCH):
    """Launches of kernel 12's reduction pass in one bf16 training step at
    ``batch``: one for each 1x1 convolution whose plan leaves more than one
    partial (its rows split over more than one cluster)."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sum(count for C, O, H, _, count in RESNET50_1X1
               if hc.conv1x1_wgrad_plan(batch * H * H, C, O, sms).workspace)


def _conv3x3_weights(net):
    return {k: p for k, p in net.collect_params().items()
            if k.endswith("_weight") and p.shape[2:] == (3, 3)}


def phase_training(card):
    """Train full-width ResNet-50 v1 (224 px, batch 32, fp32) with
    FusedTrainer SGD (lr 0.1, momentum 0.9) on gpu(0): the first step is
    checked against the same step on the CPU (the plain versions), then
    timed steps with the launch counters read around them."""
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.fused import FusedTrainer
    from mxnet_tpu_torch.ops import hopper_conv as hc
    from mxnet_tpu_torch.weights import from_jax_block
    fp32_exact()
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    t0 = time.perf_counter()
    net, x, y = gluon_resnet50(gpu(0), BATCH)
    net(x).wait_to_read()                     # deferred shapes, weights made
    w_init = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    convs = sorted(_conv3x3_weights(net))
    check(len(w_init) == 299 and len(convs) == 16,
          "resnet50_v1 has %d parameters, %d 3x3 weights"
          % (len(w_init), len(convs)))
    ft = FusedTrainer(net, "softmax_cross_entropy", "sgd", dict(opt))
    print("[training] resnet50_v1: %d parameters in %d arrays, made on "
          "gpu(0) in %.2f s" % (sum(v.size for v in w_init.values()),
                               len(w_init), time.perf_counter() - t0))

    # the main path: counts zeroed just before the first step, read after
    # the last timed one
    hc.launches = hc.conv_reduce_launches = 0
    hc.wgrad_launches = 0
    hc.wgrad_reduce_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss0 = float(ft.step(x, y).asnumpy())
    first_s = time.perf_counter() - t0
    ft.sync_params()
    w_gpu = {k: net.collect_params()[k].data().asnumpy() for k in convs}
    losses = [loss0]
    times = timed_steps(lambda: ft.step(x, y),
                        lambda loss: losses.append(float(loss.asnumpy())))
    steps = 1 + WARMUP_STEPS + TIMED_STEPS
    launches = {"implicit_gemm_conv": hc.launches,
                "implicit_gemm_conv reduction": hc.conv_reduce_launches,
                "taps_wgrad": hc.wgrad_launches,
                "taps_wgrad reduction": hc.wgrad_reduce_launches}
    want = {"implicit_gemm_conv": 32,
            "implicit_gemm_conv reduction": conv_reductions_per_step(),
            "taps_wgrad": 16,
            "taps_wgrad reduction": wgrad_reductions_per_step()}
    print("[training] %d steps ran %s launches (per step %s; expected %s)"
          % (steps, launches, {k: v / steps for k, v in launches.items()},
             want))
    check(all(launches[k] == want[k] * steps for k in want),
          "launch counts %s over %d steps, expected %s per step"
          % (launches, steps, want))
    check(all(math.isfinite(v) for v in losses),
          "non-finite loss: %s" % losses)
    step_ms = float(np.median(times)) * 1e3
    ips = BATCH / (step_ms / 1e3)
    print("[training] batch %d, first step %.1f ms, then %d timed steps: "
          "median %.2f ms (min %.2f, max %.2f), %.1f images/s on %s; "
          "losses %s" % (BATCH, first_s * 1e3, TIMED_STEPS, step_ms,
                         min(times) * 1e3, max(times) * 1e3, ips, card,
                         ["%.4f" % v for v in losses]))

    # reference: the same first step on the CPU from the same weights
    cnet, cx, cy = gluon_resnet50(cpu(), BATCH)
    from_jax_block(w_init, cnet, cpu())
    cft = FusedTrainer(cnet, "softmax_cross_entropy", "sgd", dict(opt))
    t0 = time.perf_counter()
    closs = float(cft.step(cx, cy).asnumpy())
    cpu_s = time.perf_counter() - t0
    cft.sync_params()
    rel_loss = abs(loss0 - closs) / abs(closs)
    worst = 0.0
    for k in convs:
        want = cnet.collect_params()[k].data().asnumpy() - w_init[k]
        got = w_gpu[k] - w_init[k]
        worst = max(worst, float(np.linalg.norm(got - want)
                                 / np.linalg.norm(want)))
    print("[training] first step vs the CPU (plain versions, %.1f s): loss "
          "%.6f vs %.6f (rel %.3g, tol %g); 3x3 weight updates within %.3g "
          "of their norm (tol %g)" % (cpu_s, loss0, closs, rel_loss,
                                       LOSS_RTOL, worst, UPDATE_TOL))
    check(rel_loss <= LOSS_RTOL, "first-step loss differs from the CPU by "
          "%g > %g" % (rel_loss, LOSS_RTOL))
    check(worst <= UPDATE_TOL, "a 3x3 weight update differs from the CPU's "
          "by %g > %g of its norm" % (worst, UPDATE_TOL))
    del cnet, cft, cx, cy
    return launches, {
        "images_per_s": ips, "step_ms": step_ms,
        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
        "first_step_ms": first_s * 1e3, "losses": losses,
        "cpu_check": {"batch": BATCH, "loss_rel_err": rel_loss,
                      "update_rel_err_max": worst, "cpu_step_s": cpu_s}}, \
        (ft, x, y)


def _k1_kind(name: str):
    """"bf16" or "fp32" for a launch of kernel 1 in a trace, else None."""
    if "taps_conv_bf16_kernel" in name:
        return "bf16"
    if "taps_conv_kernel" in name:
        return "fp32"
    return None


def _train_group(name: str) -> str:
    lname = name.lower()
    if "conv1x1_wgrad_kernel" in name:
        return "kernel 12 1x1 wgrad partial pass"
    if "taps_wgrad_bf16_kernel" in name:
        return "kernel 2 bf16 wgrad partial pass"
    if "taps_wgrad_kernel" in name:
        return "kernel 2 wgrad partial pass"
    if "split_sum_kernel" in name:       # csrc/split_sum.cuh, by its tag
        for tag, group in (("bf16_1x1_wgrad", "kernel 12 1x1 wgrad"),
                           ("bf16_3x3_wgrad", "kernel 2 bf16 wgrad"),
                           ("fp32_3x3_wgrad", "kernel 2 wgrad"),
                           ("fp32_3x3_conv", "kernel 1")):
            if tag in name:
                return group + " reduction pass"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    if "copy" in lname or "nchwtonhwc" in lname or "nhwctonchw" in lname:
        return "layout copies"
    if "multi_tensor_apply" in lname or "foreach" in lname:
        return "optimizer (SGD)"
    if any(k in lname for k in ("conv", "gemm", "xmma", "cudnn", "cutlass",
                                "sm80_", "sm90_")):
        return "cuDNN/cuBLAS (7x7 stem, 1x1, fc)"
    return "BN and elementwise"


def phase_training_profile(card, step, step_ms, tag="train-profile",
                           batch=BATCH, w1x1=None, bf16=False):
    """Where one training step's device time goes (torch.profiler), over
    two calls of ``step``: kernel 1 forward and dgrad told apart by order
    (a step's first 16 launches are the forward).  The idle share is taken
    against ``step_ms``, the median unprofiled step, since the profiler
    slows the host's dispatch.  ``w1x1`` is kernel 12's (partial,
    reduction) launches a step, checked in the trace when given; ``bf16``
    says which of kernels 1 and 2's libraries the step must launch (and the
    other never)."""
    n = 2
    kernels, wall_ms = profiled_kernels(step, n, tag)
    groups, counts = {}, {}
    taps_seen = {"fp32": 0, "bf16": 0}
    for e in kernels:
        kind = _k1_kind(e.name)
        if kind is not None:
            g = ("kernel 1%s %s" % (" bf16" if kind == "bf16" else "",
                                    "forward" if taps_seen[kind] % 32 < 16
                                    else "dgrad"))
            taps_seen[kind] += 1
        else:
            g = _train_group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
        counts[g] = counts.get(g, 0) + 1
    want_k1 = {"fp32": 0, "bf16": 32 * n} if bf16 else {"fp32": 32 * n,
                                                         "bf16": 0}
    check(taps_seen == want_k1, "profile saw %s kernel-1 launches in %d "
          "steps, expected %s" % (taps_seen, n, want_k1))
    k2, other = (("kernel 2 bf16 wgrad", "kernel 2 wgrad") if bf16
                 else ("kernel 2 wgrad", "kernel 2 bf16 wgrad"))
    traced = (counts.get(k2 + " partial pass", 0),
              counts.get(k2 + " reduction pass", 0))
    check(traced == (16 * n, wgrad_reductions_per_step(batch, bf16) * n)
          and not any(g.startswith(other) for g in counts),
          "profile saw %d %s partial and %d reduction launches in %d steps "
          "(and %s)" % (traced[0], k2, traced[1], n,
                        {g: c for g, c in counts.items()
                         if g.startswith(other)}))
    k1_sums = counts.get("kernel 1 reduction pass", 0)
    want_sums = 0 if bf16 else conv_reductions_per_step(batch) * n
    check(k1_sums == want_sums, "profile saw %d kernel-1 split sums in %d "
          "steps, expected %d" % (k1_sums, n, want_sums))
    if w1x1 is not None:
        seen = (counts.get("kernel 12 1x1 wgrad partial pass", 0),
                counts.get("kernel 12 1x1 wgrad reduction pass", 0))
        check(seen == (w1x1[0] * n, w1x1[1] * n),
              "profile saw %d kernel-12 partial and %d reduction launches "
              "in %d steps, expected %s a step" % (seen + (n, w1x1)))
    device_ms = sum(groups.values()) / n / 1e3
    check(device_ms > 0, "the profiler recorded no device time")
    idle = max(0.0, 1 - device_ms / step_ms)
    print("[%s] one batch-%d step: %.2f ms device busy, %.2f ms wall "
          "unprofiled (%.1f%% idle), %.2f ms wall profiled; %d launches a "
          "step on %s" % (tag, batch, device_ms, step_ms, 100 * idle,
                          wall_ms, len(kernels) // n, card))
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[%s]   %-36s %8.3f ms/step (%.1f%%), %4d launches"
              % (tag, g, us / n / 1e3, 100.0 * us / n / 1e3 / device_ms,
                 counts[g] // n))
    return {"step_device_ms": device_ms, "idle_share": idle,
            "step_wall_ms_profiled": wall_ms,
            "launches_per_step": len(kernels) // n,
            "device_ms_by_group": {g: us / n / 1e3
                                   for g, us in groups.items()},
            "launches_by_group": {g: c // n for g, c in counts.items()}}


# --------------------------------------------------------------------------
STATS_TOL = 1e-5        # kernel 4 vs plain: m absolute; acc, l of max |value|
# (B, H, Tq, Tk, D, causal): the ring's per-shard shapes at T 32,768 over
# sp 8 (a full step, a diagonal step), then ragged and odd ones
RING_STATS_SHAPES = [(1, 12, 4096, 4096, 64, False),
                     (1, 12, 4096, 4096, 64, True),
                     (2, 2, 77, 77, 32, False), (1, 3, 1000, 1000, 64, True),
                     (1, 2, 128, 384, 128, False), (1, 1, 256, 128, 64, True),
                     (2, 4, 128, 128, 16, True)]
# the long-context configuration: gpt2-small's attention (12 heads of 64),
# 32x its 1,024-token context, fp32, the sequence over sp = 8 entries of one
# card
LONG = dict(B=1, H=12, T=32768, D=64, sp=8, sp_full=4, sp_ulysses=4)
RING_FWD_TOL = 2e-5     # ring vs one un-sharded flash attention, absolute
RING_GRAD_TOL = 1e-4    # of the largest |gradient|
COMPOSE_TOL = 1e-4      # a sharded composition vs its un-sharded form, of max


def _stats_err(got, want):
    """Kernel 4 vs plain: (acc of max |acc|, m absolute, l of max |l|);
    equal infinities (a row that sees no key) count as no error."""
    errs = []
    for g, w, rel in zip(got, want, (True, False, True)):
        d = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
        errs.append(d.max().item() / (w.abs().max().item() if rel else 1.0))
    return errs


def _stats_costs(B, H, Tq, Tk, D, causal):
    """FLOPs and bytes of kernel 4: 4 D FLOP a visible pair; q, k, v read,
    acc, m and l written, fp32."""
    pairs = _visible_pairs(Tq, Tk, causal)
    return (4.0 * pairs * D * B * H,
            4.0 * B * H * (2 * Tq * D + 2 * Tk * D + 2 * Tq))


def _sdpa_lse(q, k, v, causal, scale):
    """The yardstick of kernel 4: PyTorch's memory-efficient attention
    computing its output and log-sum-exp (the nearest call; not the same
    outputs)."""
    return torch.ops.aten._scaled_dot_product_efficient_attention(
        q, k, v, None, True, 0.0, causal, scale=scale)


def _sdpa_bwd(q, k, v, do, causal, scale):
    """The yardstick of the fused backward at the ring's shapes: a call of
    the backward of PyTorch's memory-efficient attention (dq, dk and dv
    together) on the same inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             scale=scale)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                       retain_graph=True)


def phase_ring_kernels(card):
    """Kernel 4 (the stats mode of ``flash_attn_fwd.cu``) against
    ``flash_stats_plain`` at ``RING_STATS_SHAPES``, and kernel 10
    (``zero_fill.cu``) against zeros over a NaN buffer; their times beside
    the plain versions', the bound and the yardsticks.  At the ring's two
    per-shard shapes (a full step, a diagonal one) also the fused backward
    (kernels 6 and 7) with the ``lse`` of kernel 4's stats: its time, its
    kernel and dq sum apart, the launches of a call, beside its plain
    version and SDPA's memory-efficient backward.  Returns the two
    ``kernels`` entries (``launches`` and the per-path sums come from phase
    11) and the backward's times by step mode."""
    from mxnet_tpu_torch.ops import hopper_attention as ha
    from mxnet_tpu_torch.parallel import _compat
    fp32_exact()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    worst = [0.0, 0.0, 0.0]
    timed, bwd = {}, {}
    for shape in RING_STATS_SHAPES[2:] + RING_STATS_SHAPES[:2]:
        B, H, Tq, Tk, D, causal = shape
        r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa
        q, k, v = r(B, H, Tq, D), r(B, H, Tk, D), r(B, H, Tk, D)
        sc = 1.0 / math.sqrt(D)
        fwd_err, _, got, err = _fwd_check(ha, q, k, v, causal, sc, shape)
        print("[ring-kernels] kernel 4 B=%d H=%d Tq=%d Tk=%d D=%d %s: acc "
              "%.3g (of max |acc|), m %.3g (abs), l %.3g (of max l); tol %g;"
              " kernels 3 and 5 %.3g and %.3g (abs, tol %g); all bit-equal "
              "on a rerun"
              % (B, H, Tq, Tk, D, "causal" if causal else "non-causal",
                 *err, STATS_TOL, fwd_err["flash_fwd"],
                 fwd_err["flash_fwd_lse"], ATTN_FWD_TOL))
        worst = [max(a, b) for a, b in zip(worst, err)]
        if shape in RING_STATS_SHAPES[:2]:
            flops, nbytes = _stats_costs(*shape)
            bound, by = _bound(flops, nbytes)
            timed["diag" if causal else "full"] = {
                "ms": time_ms(lambda: ha.flash_attention_stats(
                    q, k, v, causal, sc)),
                "plain_ms": time_ms(lambda: ha.flash_stats_plain(
                    q, k, v, causal, sc)),
                "library_ms": time_ms(lambda: _sdpa_lse(q, k, v, causal,
                                                        sc)),
                "bound_ms": bound, "bound_by": by, "gflop": flops / 1e9}
            # the ring's backward call at this shape: lse from the stats
            do = r(B, H, Tq, D)
            acc, m, l = got
            delta = (do * acc / l.clamp_min(1e-37).unsqueeze(-1)).sum(-1)
            args = (q, k, v, do, ha.lse_of(m, l), delta, causal, sc)
            bflops, bbytes = _attn_costs(*shape)["flash_bwd"]
            bbound, bby = _bound(bflops, bbytes)
            bwd["diag" if causal else "full"] = dict(
                ms=time_ms(lambda: ha.flash_bwd(*args)),
                plain_ms=time_ms(lambda: ha.flash_bwd_plain(*args)),
                library_ms=time_ms(_sdpa_bwd(q, k, v, do, causal, sc)),
                bound_ms=bbound, bound_by=bby, gflop=bflops / 1e9,
                **_bwd_split(ha, args))
            del do, acc, m, l, delta, args
        del q, k, v, got
    for mode, t in timed.items():
        print("[ring-kernels] kernel 4 at B=1 H=12 T_loc=4096 D=64 %s: %.4f"
              " ms (%.2f TFLOP/s), bound %.4f ms (%s), plain %.4f ms, "
              "library %.4f ms (SDPA efficient attention with log-sum-exp:"
              " nearest call, not the same outputs); before the redesign "
              "%.4f ms (the last run before it, quoted)"
              % (mode, t["ms"], t["gflop"] / t["ms"], t["bound_ms"],
                 t["bound_by"], t["plain_ms"], t["library_ms"],
                 BEFORE_K345_MS[mode]))
    for mode, t in bwd.items():
        print("[ring-kernels] fused backward (kernels 6 and 7) at B=1 H=12 "
              "T_loc=4096 D=64 %s: %.4f ms (%.2f TFLOP/s at five products; "
              "kernel %.4f, dq sum %.4f; %s launches a call), bound %.4f ms "
              "(%s), plain %.4f ms, library %.4f ms (SDPA memory-efficient "
              "backward, dq, dk and dv)"
              % (mode, t["ms"], t["gflop"] / t["ms"], t["kernel_ms"],
                 t["dq_sum_ms"], t["launches_a_call"], t["bound_ms"],
                 t["bound_by"], t["plain_ms"], t["library_ms"]))
    # kernel 10 over a NaN buffer of the probe's shape
    buf = torch.full((8, 128), math.nan, device=dev)
    _compat.zero_fill(buf)
    torch.cuda.synchronize()
    zf_err = buf.abs().max().item()
    check(zf_err == 0.0, "kernel 10 left %r where zeros belong" % zf_err)
    zf = {"ms": time_ms(lambda: _compat.zero_fill(buf)),
          "plain_ms": time_ms(lambda: _compat.zero_fill_plain(buf)),
          "library_ms": time_ms(lambda: buf.zero_())}
    zf["bound_ms"], zf["bound_by"] = _bound(0.0, buf.numel() * 4.0)
    print("[ring-kernels] kernel 10 (8, 128) fp32 over NaN: max |value| "
          "after %g; %.4f ms, bound %.6f ms (bytes), plain fill_ %.4f ms, "
          "library zero_ %.4f ms, on %s"
          % (zf_err, zf["ms"], zf["bound_ms"], zf["plain_ms"],
             zf["library_ms"], card))
    k4 = {"name": "flash_attention_stats", "route": "cuda",
          "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
          "replaces": "mxnet_tpu/ops/pallas_attention.py:167",
          "max_abs_err": max(worst),
          "max_err_is": "acc and l of max |value|, m absolute",
          "per_call": timed,
          "library": "torch.ops.aten._scaled_dot_product_efficient_attention"
                     " with log-sum-exp (nearest call, not the same outputs)"}
    k10 = {"name": "zero_fill", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/zero_fill.cu",
           "replaces": "mxnet_tpu/parallel/_compat.py:45",
           "max_abs_err": zf_err, "library": "Tensor.zero_", **zf}
    return k4, k10, bwd


def _ring_counts(ha, compat):
    return {"flash_attention_stats": ha.flash_stats_launches,
            "flash_fwd": ha.flash_fwd_launches,
            "flash_fwd_lse": ha.flash_fwd_lse_launches,
            "flash_bwd": ha.flash_bwd_launches,
            "flash_dq_sum": ha.flash_dq_sum_launches,
            "zero_fill": compat.zero_fill_launches}


def _zero_ring_counts(ha, compat):
    _zero_attn_counts(ha)
    ha.flash_stats_launches = 0
    compat.zero_fill_launches = 0


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _ring_group(name: str) -> str:
    if "flash_fwd_kernel" in name:
        return _tfm_group(name)
    if "flash_bwd_kernel" in name:
        return BWD_GROUP
    if "dq_sum_kernel" in name:
        return DQ_SUM_GROUP
    if "zero_fill" in name:
        return "kernel 10 (zero_fill)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    return "merge, delta, accumulators (PyTorch elementwise)"


def _max_err(pairs):
    """Over (got, want) pairs: (max |got - want|, max |want|)."""
    return (max((a - b).abs().max().item() for a, b in pairs),
            max(b.abs().max().item() for _, b in pairs))


def _long_context_kernel_checks(ha, q, k, v, g, sp, sp_ulysses):
    """Kernel 5 and the fused backward (kernels 6 and 7) against their
    plain versions at the shapes and with the inputs the long-context path
    gives them.  The ring's backward: the fused kernel at the per-shard
    shape for the last Q shard (which sees every K/V shard), fed the
    combined full-sequence ``lse`` and ``delta`` of that shard (taken here
    in dense fp32 over the keys it sees), for a full step (K/V of shard 0)
    and the diagonal one, each call also timed and its launches counted.
    Ulysses: kernel 5 and the fused backward at one device's shape (``H /
    sp_ulysses`` heads over the whole sequence), the plain versions taken
    head by head.  Returns each kernel's worst error (out and lse absolute,
    gradients of max |value|) and the ring calls' times."""
    B, H, T, D = q.shape
    L, idx, sc = T // sp, sp - 1, 1.0 / math.sqrt(D)
    part = lambda t, i: t[:, :, i * L:(i + 1) * L].contiguous()  # noqa
    qi, gi = part(q, idx), part(g, idx)
    seen = (idx + 1) * L
    vis = ((idx * L + torch.arange(L, device=q.device))[:, None]
           >= torch.arange(seen, device=q.device)[None, :])
    lse = torch.empty(B, H, L, device=q.device)
    delta = torch.empty(B, H, L, device=q.device)
    for h in range(H):
        s = torch.matmul(qi[:, h], k[:, h, :seen].transpose(-1, -2)) * sc
        s.masked_fill_(~vis, -math.inf)
        lse[:, h] = torch.logsumexp(s, -1)
        out_h = torch.matmul(torch.exp(s - lse[:, h, :, None]),
                             v[:, h, :seen])
        delta[:, h] = (gi[:, h] * out_h).sum(-1)
        del s, out_h
    errs, times = {"flash_dq": 0.0, "flash_dkv": 0.0}, {}
    for mode, src in (("full", 0), ("diag", idx)):
        ks, vs, diag = part(k, src), part(v, src), mode == "diag"
        own = ha.flash_fwd_plain(qi, ks, vs, diag, sc)[1]
        gap = lse - own
        args = (qi, ks, vs, gi, lse, delta, diag, sc)
        got, want = ha.flash_bwd(*args), ha.flash_bwd_plain(*args)
        torch.cuda.synchronize()
        err = [_rel(a, b) for a, b in zip(got, want)]
        call_ms = time_ms(lambda: ha.flash_bwd(*args), iters=5, warmup=1)
        before = (ha.flash_bwd_launches, ha.flash_dq_sum_launches)
        ha.flash_bwd(*args)
        launched = (ha.flash_bwd_launches - before[0],
                    ha.flash_dq_sum_launches - before[1])
        check(launched == (1, 1), "one ring backward call launched %s "
              "(fused kernel, dq sum), expected (1, 1)" % (launched,))
        times[mode] = {"ms": call_ms, "launches_a_call": launched}
        print("[long-context] ring backward, Q shard %d, K/V shard %d (%s): "
              "the fused backward at B=%d H=%d T_loc=%d D=%d with the "
              "combined lse (%.3g to %.3g above the step's own) vs plain: dq "
              "%.3g, dk %.3g, dv %.3g (of max |value|, tol %g); %.4f ms a "
              "call, %s launches (fused kernel, dq sum)"
              % (idx, src, mode, B, H, L, D, gap.min().item(),
                 gap.max().item(), *err, RING_GRAD_TOL, call_ms, launched))
        check(gap.min().item() > 0, "the combined lse is not above the "
              "step's own: the check would not test an outside lse")
        check(max(err) <= RING_GRAD_TOL, "the fused backward disagrees with "
              "plain on the ring's %s step: %s" % (mode, err))
        errs["flash_dq"] = max(errs["flash_dq"], err[0])
        errs["flash_dkv"] = max(errs["flash_dkv"], *err[1:])
        del got, want, own, gap
    del qi, gi, lse, delta, vis
    # Ulysses: one device's heads over the whole sequence, causal
    Hu = H // sp_ulysses
    qu, ku, vu, gu = (t[:, :Hu].contiguous() for t in (q, k, v, g))
    out5, lse5 = ha.flash_fwd_lse(qu, ku, vu, True, sc)
    delta5 = (gu * out5).sum(-1)
    grads = ha.flash_bwd(qu, ku, vu, gu, lse5, delta5, True, sc)
    torch.cuda.synchronize()
    fwd_pairs, bwd_pairs = [], [[], [], []]
    for h in range(Hu):
        one = lambda t: t[:, h:h + 1]  # noqa: E731
        want_out, want_lse = ha.flash_fwd_plain(one(qu), one(ku), one(vu),
                                                True, sc)
        fwd_pairs.append(_max_err([(one(out5), want_out),
                                   (one(lse5), want_lse)]))
        del want_out, want_lse
        want = ha.flash_bwd_plain(one(qu), one(ku), one(vu), one(gu),
                                  one(lse5), one(delta5), True, sc)
        for acc, got_g, want_g in zip(bwd_pairs, grads, want):
            acc.append(_max_err([(one(got_g), want_g)]))
        del want
    fwd_err = max(d for d, _ in fwd_pairs)
    bwd_err = [max(d for d, _ in acc) / max(w for _, w in acc)
               for acc in bwd_pairs]
    print("[long-context] Ulysses device: kernel 5 at B=%d H=%d T=%d D=%d "
          "causal vs plain %.3g (out and lse, abs, tol %g); fused backward "
          "dq %.3g, dk %.3g, dv %.3g (of max |value|, tol %g)"
          % (B, Hu, T, D, fwd_err, RING_FWD_TOL, *bwd_err, RING_GRAD_TOL))
    check(fwd_err <= RING_FWD_TOL, "kernel 5 disagrees with plain at "
          "Ulysses' shape: %g" % fwd_err)
    check(max(bwd_err) <= RING_GRAD_TOL, "the fused backward disagrees with "
          "plain at Ulysses' shape: %s" % bwd_err)
    errs["flash_fwd_lse"] = fwd_err
    errs["flash_dq"] = max(errs["flash_dq"], bwd_err[0])
    errs["flash_dkv"] = max(errs["flash_dkv"], *bwd_err[1:])
    del qu, ku, vu, gu, out5, lse5, delta5, grads
    torch.cuda.empty_cache()
    return errs, times


def phase_long_context(card):
    """Phase 11: ``models.long_context_attention`` at gpt2-small's attention
    geometry and T 32,768 on ``make_mesh({"sp": 8}, [cuda:0] * 8)``, forward
    and backward of ``sum(out * g)``: launch counts, agreement with one
    un-sharded flash attention and with the scan arm, a non-causal ring and
    Ulysses, kernels 5, 6 and 7 against plain at this path's shapes, times beside the un-sharded kernels and SDPA, and a profile.
    Returns (launches of the main path, summary)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.models import long_context_attention
    from mxnet_tpu_torch.ops import hopper_attention as ha
    from mxnet_tpu_torch.parallel import _compat, make_mesh
    from mxnet_tpu_torch.parallel.ring_attention import (ring_attention,
                                                         ulysses_attention)
    fp32_exact()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    B, H, T, D, sp = (LONG[k] for k in ("B", "H", "T", "D", "sp"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    q, k, v, g = (torch.randn(B, H, T, D, device=dev, generator=gen)
                  for _ in range(4))
    mesh = make_mesh({"sp": sp}, devices=[dev] * sp)
    n_pairs = sp * (sp + 1) // 2

    # the main path, counted: the causal ring forward and backward
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    _zero_ring_counts(ha, _compat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = long_context_attention(qg, kg, vg, mesh, axis="sp")
    grads = torch.autograd.grad(out, (qg, kg, vg), g)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _ring_counts(ha, _compat)
    want = {"flash_attention_stats": n_pairs, "flash_fwd": 0,
            "flash_fwd_lse": 0, "flash_bwd": n_pairs,
            "flash_dq_sum": n_pairs,
            "zero_fill": 1}
    print("[long-context] B=%d H=%d T=%d D=%d causal fp32 over sp=%d (one "
          "card): forward and backward ran %s launches (expected %s), "
          "first call %.2f s" % (B, H, T, D, sp, launches, want, first_s))
    check(launches == want, "the ring's launches %s, expected %s"
          % (launches, want))

    # one un-sharded flash attention over the whole sequence (kernels 5-7)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref = ha.flash_attention(qr, kr, vr, causal=True)
    ref_grads = torch.autograd.grad(ref, (qr, kr, vr), g)
    fwd_err = (out - ref).abs().max().item()
    grad_err = [_rel(a, b) for a, b in zip(grads, ref_grads)]
    with torch.no_grad():
        scan = ring_attention(q, k, v, mesh, axis="sp", causal=True,
                              use_pallas=False)
    scan_err = (out - scan).abs().max().item()
    del scan
    print("[long-context] ring vs un-sharded flash attention: out %.3g "
          "(abs, tol %g), dq %.3g, dk %.3g, dv %.3g (of max |grad|, tol %g);"
          " vs the scan arm on the card: out %.3g (abs, tol %g)"
          % (fwd_err, RING_FWD_TOL, *grad_err, RING_GRAD_TOL, scan_err,
             RING_FWD_TOL))
    check(fwd_err <= RING_FWD_TOL and scan_err <= RING_FWD_TOL,
          "the ring's output disagrees: %g, %g" % (fwd_err, scan_err))
    check(max(grad_err) <= RING_GRAD_TOL, "the ring's gradients disagree: "
          "%s" % grad_err)
    check(all(bool(torch.isfinite(t).all()) for t in (out, *grads)),
          "non-finite ring output or gradient")
    del grads, ref_grads, qr, kr, vr

    # a non-causal ring at sp 4 against the un-sharded kernel 3
    mesh4 = make_mesh({"sp": LONG["sp_full"]}, devices=[dev] * LONG["sp_full"])
    with torch.no_grad():
        before = ha.flash_stats_launches
        full = long_context_attention(q, k, v, mesh4, causal=False)
        full_launches = ha.flash_stats_launches - before
        full_err = (full - ha.flash_attention(q, k, v)).abs().max().item()
    print("[long-context] non-causal ring at sp=%d: %d launches of kernel 4 "
          "(expected %d), vs un-sharded flash %.3g (tol %g)"
          % (LONG["sp_full"], full_launches, LONG["sp_full"] ** 2, full_err,
             RING_FWD_TOL))
    check(full_launches == LONG["sp_full"] ** 2 and full_err <= RING_FWD_TOL,
          "the non-causal ring failed: %d launches, error %g"
          % (full_launches, full_err))
    del full

    # Ulysses at sp 4: 3 heads a device, forward and gradients
    qu, ku, vu = (t.clone().requires_grad_() for t in (q, k, v))
    uly = ulysses_attention(qu, ku, vu, mesh4, axis="sp", causal=True)
    uly_grads = torch.autograd.grad(uly, (qu, ku, vu), g)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref_grads = torch.autograd.grad(ha.flash_attention(qr, kr, vr, True),
                                    (qr, kr, vr), g)
    uly_err = (uly - ref).abs().max().item()
    uly_grad_err = max(_rel(a, b) for a, b in zip(uly_grads, ref_grads))
    print("[long-context] Ulysses at sp=%d (%d heads a device): out %.3g, "
          "grads %.3g of max" % (LONG["sp_ulysses"], H // LONG["sp_ulysses"],
                                 uly_err, uly_grad_err))
    check(uly_err <= RING_FWD_TOL and uly_grad_err <= RING_GRAD_TOL,
          "Ulysses disagrees: %g, %g" % (uly_err, uly_grad_err))
    del uly, uly_grads, ref_grads, qu, ku, vu, qr, kr, vr, out, ref
    torch.cuda.empty_cache()

    # kernels 5, 6 and 7 against plain at this path's shapes and inputs
    kernel_errs, bwd_calls = _long_context_kernel_checks(
        ha, q, k, v, g, sp, LONG["sp_ulysses"])

    # times: the ring, one un-sharded flash attention, SDPA (yardstick)
    pairs = _visible_pairs(T, T, True)
    fwd_flop, train_flop = 4.0 * pairs * D * B * H, 18.0 * pairs * D * B * H

    def fwd_bwd(fn):
        qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))

        def run():
            torch.autograd.grad(fn(qt, kt, vt), (qt, kt, vt), g)
        return run

    def ring(a, b, c):
        return long_context_attention(a, b, c, mesh, axis="sp")

    def sdpa(a, b, c):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(a, b, c, is_causal=True)

    times = {}
    for name, fn in (("ring", ring),
                     ("flash", lambda a, b, c: ha.flash_attention(a, b, c,
                                                                  True)),
                     ("sdpa", sdpa)):
        with torch.no_grad():
            fwd_ms = time_ms(lambda: fn(q, k, v), iters=5, warmup=1)
        train_ms = time_ms(fwd_bwd(fn), iters=3, warmup=1)
        times[name] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": train_ms,
                       "fwd_tokens_per_s": B * T / fwd_ms * 1e3,
                       "fwd_bwd_tokens_per_s": B * T / train_ms * 1e3,
                       "fwd_tflops": fwd_flop / fwd_ms / 1e9,
                       "fwd_bwd_tflops": train_flop / train_ms / 1e9}
        print("[long-context] %-5s forward %.2f ms (%.0f tokens/s, %.2f "
              "TFLOP/s), forward+backward %.2f ms (%.0f tokens/s, %.2f "
              "TFLOP/s by the kernels' 18 D FLOP a visible pair)"
              % (name, fwd_ms, times[name]["fwd_tokens_per_s"],
                 times[name]["fwd_tflops"], train_ms,
                 times[name]["fwd_bwd_tokens_per_s"],
                 times[name]["fwd_bwd_tflops"]))
    print("[long-context] sdpa is PyTorch's memory-efficient attention, the "
          "yardstick only; bound at this shape: forward %.2f ms, forward and "
          "backward %.2f ms (fp32 FLOPs / 67 TFLOP/s) on %s"
          % (fwd_flop / PEAK_FP32 * 1e3, train_flop / PEAK_FP32 * 1e3, card))

    # where a ring step's time goes
    run = fwd_bwd(ring)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    groups, counts = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        grp = _ring_group(e.name)
        groups[grp] = groups.get(grp, 0.0) + e.time_range.elapsed_us() / 1e3
        counts[grp] = counts.get(grp, 0) + 1
    device_ms = sum(groups.values())
    check(device_ms > 0, "the profiler recorded no device time")
    print("[long-context] one ring forward+backward under the profiler: "
          "%.2f ms device busy" % device_ms)
    for grp, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[long-context]   %-48s %9.3f ms (%.1f%%), %5d launches"
              % (grp, ms, 100.0 * ms / device_ms, counts[grp]))
    merge = groups.get("merge, delta, accumulators (PyTorch elementwise)",
                       0.0)
    summary = {"shape": LONG, "launches": launches, "first_call_s": first_s,
               "fwd_err": fwd_err, "grad_err": grad_err, "scan_err": scan_err,
               "full_ring_launches": full_launches, "full_err": full_err,
               "ulysses_err": [uly_err, uly_grad_err],
               "kernel_checks": kernel_errs, "times": times,
               "backward_calls": bwd_calls,
               "profile_ms": groups, "profile_launches": counts,
               "merge_share": merge / device_ms}
    del q, k, v, g
    torch.cuda.empty_cache()
    return launches, summary


def phase_compositions(card):
    """Phase 12: the tensor-, expert- and pipeline-parallel compositions at
    gpt2-small's width on meshes whose entries repeat cuda:0, each against
    its un-sharded form on the card, with times."""
    from mxnet_tpu_torch.models import (block_apply, get_config,
                                        init_block_params,
                                        moe_transformer_ffn,
                                        pipeline_transformer)
    from mxnet_tpu_torch.parallel import make_mesh, moe, tensor_parallel
    fp32_exact()
    dev = torch.device("cuda", 0)
    cfg = get_config("gpt2-small")
    d, f = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    mesh4 = lambda axis: make_mesh({axis: 4}, devices=[dev] * 4)  # noqa
    summary = {}

    # tensor parallel: 768 -> 3072 -> 768 over tp 4, 8,192 tokens
    x = r(8192, d)
    w1, w2 = r(d, f) / math.sqrt(d), r(f, d) / math.sqrt(f)
    with torch.no_grad():
        got = tensor_parallel.mlp_block(x, w1, w2, mesh4("tp"))
        want = torch.relu(x @ w1) @ w2
        err = _rel(got, want)
        t_tp = time_ms(lambda: tensor_parallel.mlp_block(x, w1, w2,
                                                         mesh4("tp")), 5, 1)
        t_one = time_ms(lambda: torch.relu(x @ w1) @ w2, 5, 1)
    print("[compositions] mlp_block 768->3072->768, %d tokens, tp=4: %.3g "
          "of max vs un-sharded (tol %g); %.3f ms vs %.3f ms un-sharded"
          % (x.shape[0], err, COMPOSE_TOL, t_tp, t_one))
    check(err <= COMPOSE_TOL, "mlp_block disagrees: %g" % err)
    summary["mlp_block"] = {"err": err, "ms": t_tp, "unsharded_ms": t_one}

    # expert parallel: 8 experts of 768 -> 3072, k 2, capacity 1.25, ep 4;
    # each shard's capacity comes from its own 2,048 tokens, so the
    # un-sharded form is the no-mesh layer on each shard's tokens
    params = moe.init_moe_params(np.random.RandomState(SEED + 12), d, f,
                                 8).to(dev)
    x = r(4, 2048, d)
    with torch.no_grad():
        got = moe_transformer_ffn(x, params, mesh=mesh4("ep"), axis="ep")
        want = torch.stack([moe_transformer_ffn(c, params) for c in x])
        whole = moe_transformer_ffn(x, params)
        err = _rel(got, want)
        t_ep = time_ms(lambda: moe_transformer_ffn(x, params,
                                                   mesh=mesh4("ep")), 5, 1)
        t_one = time_ms(lambda: moe_transformer_ffn(x, params), 5, 1)
        tokens = x.numel() // d
        kept, routes = [], []
        for xs in (x.reshape(-1, d), x[0]):
            cap = int(np.ceil(1.25 * 2 * xs.shape[0] / 8))
            w_, ids = moe.top_k_gating(xs @ params.wg, 2)
            kept.append(int(moe._dispatch_mask(ids, w_, 8, cap)[0].sum()))
            routes.append((2 * xs.shape[0], cap))
    print("[compositions] moe_transformer_ffn 8 experts 768->3072, k=2, "
          "capacity 1.25, %d tokens, ep=4: %.3g of max vs the no-mesh "
          "layer on each shard's tokens (tol %g); the no-mesh layer over all "
          "tokens differs by %.3g of max: it keeps %d of %d routes "
          "(capacity %d), shard 0 keeps %d of %d (capacity %d); %.3f ms vs "
          "%.3f ms no-mesh" % (tokens, err, COMPOSE_TOL, _rel(got, whole),
                               kept[0], *routes[0], kept[1], *routes[1],
                               t_ep, t_one))
    check(err <= COMPOSE_TOL, "moe_transformer_ffn disagrees: %g" % err)
    summary["moe"] = {"err": err, "vs_whole": _rel(got, whole),
                      "routes_kept": kept, "ms": t_ep, "unsharded_ms": t_one}
    del params, x, got, want, whole

    # pipeline: 4 gpt2-small blocks over pp 4, batch 8 x 1024, 4 micro
    rng = np.random.RandomState(SEED + 12)
    blocks = [init_block_params(cfg, rng) for _ in range(4)]
    stacked = {kk: torch.stack([b[kk] for b in blocks]).to(dev)
               for kk in blocks[0]}
    x = r(8, cfg.seq_len, d)

    def sequential():
        y = x
        for s in range(4):
            y = block_apply(cfg, {kk: vv[s] for kk, vv in stacked.items()}, y)
        return y

    with torch.no_grad():
        got = pipeline_transformer(mesh4("pp"), "pp", cfg, stacked, x, 4)
        want = sequential()
        err = _rel(got, want)
        t_pp = time_ms(lambda: pipeline_transformer(mesh4("pp"), "pp", cfg,
                                                    stacked, x, 4), 3, 1)
        t_one = time_ms(sequential, 3, 1)
    print("[compositions] pipeline_transformer 4 gpt2-small blocks, pp=4, "
          "batch 8 x %d, 4 microbatches: %.3g of max vs the blocks in "
          "sequence (tol %g); %.3f ms vs %.3f ms in sequence, on %s"
          % (cfg.seq_len, err, COMPOSE_TOL, t_pp, t_one, card))
    check(err <= COMPOSE_TOL and bool(torch.isfinite(got).all()),
          "pipeline_transformer disagrees: %g" % err)
    summary["pipeline"] = {"err": err, "ms": t_pp, "sequential_ms": t_one}
    del stacked, x, got, want
    torch.cuda.empty_cache()
    return summary


# --------------------------------------------------------------------------
# kernel 11: user CUDA C compiled at run time (mx.rtc.CudaModule, NVRTC)
RTC_AXPY_N = 1 << 26
# the reference's three test bodies (tests/test_profiler_aux.py:121-146) in
# CUDA, an axpy, and a template scale exported for bf16; fp32 without FMA
# contraction, so each kernel is the same arithmetic as its plain expression
RTC_SOURCE = r"""
#include <cuda_bf16.h>
extern "C" __global__ void add_one(const float *x, float *o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1.0f;
}
extern "C" __global__ void row_scale(const float *x, float *o, int cols) {
  int row = blockIdx.x, c = threadIdx.x;
  if (c < cols) o[row * cols + c] = x[row * cols + c] * 3.0f;
}
extern "C" __global__ void axpy(const float *x, float *y, float a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += a * x[i];
}
template <typename T>
__global__ void scale(const T *x, T *y, float s, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = T(float(x[i]) * s);
}
"""
RTC_SIGS = {
    "add_one": "const float *x, float *o, int n",
    "row_scale": "const float *x, float *o, int cols",
    "axpy": "const float *x, float *y, float a, int n",
    "scale<__nv_bfloat16>": "const __nv_bfloat16 *x, __nv_bfloat16 *y, "
                            "float s, int n",
}


def phase_rtc(card):
    """Kernel 11: ``rtc.CudaModule`` compiles ``RTC_SOURCE`` with NVRTC
    (``--fmad=false``), then the user path launches each kernel once with
    the counters zeroed just before and read just after: add-one over
    (8, 16), the row scale over a grid of 4 rows, axpy (a = 2.5) at n =
    2^26, and the bf16 scale (s = 0.3) at 2^20; a kernel the module does
    not export must raise.  Each result against its PyTorch expression:
    fp32 to the bit, bf16 within one ulp.  axpy's time beside its bound,
    the plain expression ``y + a * x`` and the yardstick
    ``y.add_(x, alpha=a)`` (not called by the port).  Returns the
    ``kernels`` entry."""
    from mxnet_tpu_torch import MXNetError, gpu, rtc
    fp32_exact()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    mod = rtc.CudaModule(RTC_SOURCE, options=("--fmad=false",),
                         exports=("scale<__nv_bfloat16>",))
    compile_s = mod.compile_seconds
    print("[rtc] NVRTC compiled %d kernels for %s in %.3f s (CudaModule "
          "made in %.3f s); symbols %s"
          % (len(RTC_SIGS), rtc.ARCH, compile_s, time.perf_counter() - t0,
             sorted(mod.program.functions)))
    ks = {name: mod.get_kernel(name, sig) for name, sig in RTC_SIGS.items()}
    try:
        mod.get_kernel("nope", "const float *x")
        missing = None
    except MXNetError as e:
        missing = str(e)
    check(missing is not None, "get_kernel of a missing export did not "
          "raise")
    print("[rtc] missing export raises: %s" % missing.splitlines()[0])
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)  # noqa: E731
    ctx, n, nb, a, sc = gpu(0), RTC_AXPY_N, 1 << 20, 2.5, 0.3
    x1, x4, xa, y0 = r(8, 16), r(4, 8), r(n), r(n)
    xb = r(nb).to(torch.bfloat16)
    o1, o4, ya, yb = (torch.empty_like(x1), torch.empty_like(x4),
                      y0.clone(), torch.empty_like(xb))
    # the user path, counted
    for k in ks.values():
        k.launches = 0
    ks["add_one"].launch([x1, o1, x1.numel()], ctx, (1,), (128,))
    ks["row_scale"].launch([x4, o4, 8], ctx, (4,), (8,))
    ks["axpy"].launch([xa, ya, a, n], ctx, ((n + 255) // 256,), (256,))
    ks["scale<__nv_bfloat16>"].launch([xb, yb, sc, nb], ctx,
                                      ((nb + 255) // 256,), (256,))
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in ks.items()}
    print("[rtc] launches on the user path: %s" % launches)
    check(all(v == 1 for v in launches.values()),
          "rtc launch counts %s, expected 1 each" % launches)
    want_b = (xb.float() * sc).to(torch.bfloat16)
    ulp = (torch.finfo(torch.bfloat16).eps * want_b.float().abs()) \
        .clamp_min(torch.finfo(torch.bfloat16).tiny)
    errs = {"add_one": (o1 - (x1 + 1.0)).abs().max().item(),
            "row_scale": (o4 - x4 * 3.0).abs().max().item(),
            "axpy": (ya - (y0 + a * xa)).abs().max().item(),
            "scale<__nv_bfloat16>": (yb.float() - want_b.float()).abs()
            .max().item()}
    bf16_ulps = ((yb.float() - want_b.float()).abs() / ulp).max().item()
    print("[rtc] max |kernel - plain|: %s; bf16 scale within %.3g ulp"
          % (errs, bf16_ulps))
    check(all(errs[k] == 0.0 for k in ("add_one", "row_scale", "axpy")),
          "an fp32 user kernel differs from its plain expression: %s" % errs)
    check(bf16_ulps <= 1.0, "the bf16 scale is %g ulp off" % bf16_ulps)
    yk, yp, yl = y0.clone(), y0.clone(), y0.clone()
    axpy = ks["axpy"]
    t = {"ms": time_ms(lambda: axpy.launch([xa, yk, a, n], ctx,
                                           ((n + 255) // 256,), (256,))),
         "plain_ms": time_ms(lambda: torch.add(yp, a * xa, out=yp)),
         "library_ms": time_ms(lambda: yl.add_(xa, alpha=a))}
    t["bound_ms"], t["bound_by"] = _bound(2.0 * n, 3 * 4.0 * n)
    print("[rtc] axpy n=2^26 fp32: %.4f ms (%.0f GB/s), bound %.4f ms (%s),"
          " plain y + a*x %.4f ms, library y.add_(x, alpha=a) %.4f ms, on %s"
          % (t["ms"], 12.0 * n / t["ms"] / 1e6, t["bound_ms"], t["bound_by"],
             t["plain_ms"], t["library_ms"], card))
    return {"name": "rtc_cuda_module", "route": "cuda",
            "source": "mxnet_tpu_torch/rtc.py (NVRTC; the user's source, "
                      "chip_smoke.py RTC_SOURCE)",
            "replaces": "mxnet_tpu/rtc.py:117",
            "launches": sum(launches.values()), "per_kernel": launches,
            "max_abs_err": max(errs.values()), "bf16_ulps": bf16_ulps,
            "nvrtc_compile_s": compile_s,
            "timed": "axpy at n = 2^26 fp32", "library": "Tensor.add_",
            **t}


# --------------------------------------------------------------------------
# the classic Module path: bench.py's _multichip_run (bench.py:307-340) on
# one context
R50MOD = dict(batch=32, classes=1000, lr=0.1, momentum=0.9, init_seed=7,
              data_seed=3, fit_rows=128, fit_seed=5)
R50MOD_UPDATE_TOL = 0.01      # first step vs the CPU: every update's norm
R50MOD_3X3_TOL = 0.05         # ... and a 3x3 weight's (as phase 5), or one
R50MOD_SPREAD = 0.005         # that moves by this share of its norm on the
                              # card when the input is scaled by 1 + 1e-7
R50MOD_ZERO_GRAD_TOL = 1e-5   # max |update| of a bias whose gradient is 0


def r50_module(ctx, arg_params=None, aux_params=None):
    """bench.py's ``_multichip_symbol("resnet50")`` through the port:
    ``resnet50_v1()`` on ``sym.var("data")``, then ``SoftmaxOutput``, bound
    at batch 32 x 3 x 224 x 224 on ``ctx``; ``Xavier(gaussian, 2)`` after
    ``random.seed(7)`` (or the given weights); SGD lr 0.1 momentum 0.9
    through ``kvstore='local'``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with mx.name.NameManager():
        out = vision.resnet50_v1(classes=R50MOD["classes"])(
            mx.sym.var("data"))
    net = mx.sym.SoftmaxOutput(out, mx.sym.var("softmax_label"),
                               name="softmax")
    mod = mx.mod.Module(net, data_names=("data",),
                        label_names=("softmax_label",), context=[ctx])
    B = R50MOD["batch"]
    mod.bind(data_shapes=[("data", (B, 3, 224, 224))],
             label_shapes=[("softmax_label", (B,))])
    if arg_params is None:
        mx.random.seed(R50MOD["init_seed"])
        mod.init_params(mx.init.Xavier(rnd_type="gaussian", magnitude=2.0))
    else:
        mod.init_params(initializer=None, arg_params=arg_params,
                        aux_params=aux_params)
    mod.init_optimizer(kvstore="local", optimizer="sgd",
                       optimizer_params={"learning_rate": R50MOD["lr"],
                                         "momentum": R50MOD["momentum"]})
    return mod


def r50_batch(ctx):
    """bench.py's batch (bench.py:319-322): ``RandomState(3)`` images in
    U[0, 1) and class labels."""
    import mxnet_tpu_torch as mx
    B = R50MOD["batch"]
    rs = np.random.RandomState(R50MOD["data_seed"])
    x = rs.uniform(size=(B, 3, 224, 224)).astype(np.float32)
    y = rs.randint(0, R50MOD["classes"], (B,)).astype(np.float32)
    return mx.io.DataBatch([mx.nd.array(x, ctx)], [mx.nd.array(y, ctx)])


def _host_params(mod):
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _one_step(mod, batch):
    mod.forward_backward(batch)
    mod.update()
    probs = mod.get_outputs()[0].asnumpy()
    return probs, _host_params(mod)[0]


def _biases_into_batchnorm(net):
    """The biases of convolutions whose output goes only to a BatchNorm:
    BatchNorm subtracts the batch mean, so their gradient is exactly zero
    and a computed update is rounding residue."""
    nodes = net._topo()
    users = {}
    for n in nodes:
        for p, _ in n.inputs:
            users.setdefault(id(p), []).append(n)
    out = set()
    for n in nodes:
        if n.is_var or n.op.name != "Convolution" or len(n.inputs) < 3:
            continue
        if all(not u.is_var and u.op.name == "BatchNorm"
               for u in users.get(id(n), [])):
            out.add(n.inputs[2][0].name)
    return out


def _update_errs(got, want, w0):
    """Each parameter's update against the reference update, in norm."""
    out = {}
    for k, w in w0.items():
        ref = want[k] - w
        out[k] = float(np.linalg.norm((got[k] - w) - ref)
                       / max(np.linalg.norm(ref), 1e-30))
    return out


def phase_module(card):
    """bench.py's ``_multichip_run`` on one context (``r50_module``): the
    first fused step, counted, against the eager path
    (``MXNET_TPU_FUSED_STEP=0``) on the card and against the CPU's (plain
    versions), each update within 1% of its norm (5% for the 3x3
    weights), ``fc1``'s (``dense0``) update non-zero; 2 warm-up and 10
    timed steps give train images/s; then ``fit`` (1 epoch of 4 batches
    of an ``NDArrayIter`` of 128 seeded images in a ``PrefetchingIter``,
    acc and ce, ``Speedometer``, ``do_checkpoint``), ``Module.load`` with
    the optimizer states, ``score`` equal to the trained module's and
    ``predict`` of (128, 1000) rows summing to 1."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    t_phase = time.perf_counter()
    os.environ.pop("MXNET_CKPT_DIR", None)
    mod = r50_module(gpu(0))
    w0, a0 = _host_params(mod)
    fc1 = "resnetv10_dense0_weight"
    convs = {k for k, v in w0.items() if v.ndim == 4 and v.shape[2:] == (3, 3)}
    zero_grad = _biases_into_batchnorm(mod.symbol)
    check(len(w0) == 193 and len(convs) == 16 and fc1 in w0,
          "resnet50_v1 symbol: %d parameters, %d 3x3 weights"
          % (len(w0), len(convs)))
    batch = r50_batch(gpu(0))

    # the main path, counted: counts zeroed just before the first step,
    # read after the last timed one
    hc.launches = hc.wgrad_launches = hc.wgrad_reduce_launches = 0
    hc.conv_reduce_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_gpu, w_gpu = _one_step(mod, batch)
    first_s = time.perf_counter() - t0
    times = timed_steps(lambda: (mod.forward_backward(batch), mod.update()))
    out = mod.get_outputs()[0].asnumpy()
    steps = 1 + WARMUP_STEPS + TIMED_STEPS
    launches = {"implicit_gemm_conv": hc.launches,
                "implicit_gemm_conv reduction": hc.conv_reduce_launches,
                "taps_wgrad": hc.wgrad_launches,
                "taps_wgrad reduction": hc.wgrad_reduce_launches}
    want = {"implicit_gemm_conv": 32,
            "implicit_gemm_conv reduction": conv_reductions_per_step(),
            "taps_wgrad": 16,
            "taps_wgrad reduction": wgrad_reductions_per_step()}
    print("[module] %d fused steps ran %s launches (per step %s; expected "
          "%s)" % (steps, launches, {k: v / steps for k, v in
                                      launches.items()}, want))
    check(all(launches[k] == want[k] * steps for k in want),
          "Module launch counts %s over %d steps, expected %s per step"
          % (launches, steps, want))
    check(bool(np.isfinite(out).all()) and bool(np.isfinite(p_gpu).all()),
          "non-finite Module outputs")
    step_ms = float(np.median(times)) * 1e3
    ips = R50MOD["batch"] / (step_ms / 1e3)
    print("[module] resnet50_v1 -> SoftmaxOutput through Module, batch %d, "
          "first step %.1f ms, then %d timed steps: median %.2f ms (min "
          "%.2f, max %.2f), %.1f train images/s on %s"
          % (R50MOD["batch"], first_s * 1e3, TIMED_STEPS, step_ms,
             min(times) * 1e3, max(times) * 1e3, ips, card))

    def _step():
        mod.forward_backward(batch)
        mod.update()

    profile = phase_training_profile(card, _step, step_ms, "module-profile")
    del mod

    # the conditioning floor: the same first step on the card from the
    # input scaled by 1 + 1e-7
    smod = r50_module(gpu(0), w0, a0)
    xs = batch.data[0].asnumpy() * np.float32(1 + 1e-7)
    _, w_spread = _one_step(smod, mx.io.DataBatch(
        [mx.nd.array(xs, gpu(0))], batch.label))
    del smod
    spread = _update_errs(w_spread, w_gpu, w0)
    loose = {k for k, v in spread.items()
             if v >= R50MOD_SPREAD and k not in zero_grad} | convs
    print("[module] the input scaled by 1 + 1e-7 moves %d updates by >= %g "
          "of their norm (the 16 3x3 weights by %.3g-%.3g); those and the "
          "3x3 weights are held at %g, the rest at %g"
          % (len(loose - convs), R50MOD_SPREAD,
             min(spread[k] for k in convs), max(spread[k] for k in convs),
             R50MOD_3X3_TOL, R50MOD_UPDATE_TOL))

    # the first step on the eager path (MXNET_TPU_FUSED_STEP=0) and on the
    # CPU, from the same weights and batch
    os.environ["MXNET_TPU_FUSED_STEP"] = "0"
    try:
        emod = r50_module(gpu(0), w0, a0)
        p_eager, w_eager = _one_step(emod, batch)
        check(not emod._fused_step.eligible(), "the eager Module took the "
              "fused step")
        del emod
    finally:
        os.environ.pop("MXNET_TPU_FUSED_STEP")
    t0 = time.perf_counter()
    cmod = r50_module(cpu(), w0, a0)
    p_cpu, w_cpu = _one_step(cmod, r50_batch(cpu()))
    cpu_s = time.perf_counter() - t0
    del cmod
    results = {}
    for label, probs, w in (("eager", p_eager, w_eager),
                            ("cpu", p_cpu, w_cpu)):
        errs = _update_errs(w_gpu, w, w0)
        name3 = max(loose, key=errs.get)
        worst3 = errs[name3]
        rest = [k for k in errs if k not in loose and k not in zero_grad]
        name = max(rest, key=errs.get)
        worst = errs[name]
        residue = max(float(np.abs(ws[k] - w0[k]).max())
                      for ws in (w_gpu, w) for k in zero_grad)
        perr = float(np.abs(p_gpu - probs).max())
        results[label] = {"prob_err": perr, "update_err_loose": worst3,
                          "worst_loose": name3, "loose": len(loose),
                          "loose_spread": spread[name3],
                          "update_err_other": worst, "worst_other": name,
                          "fc1_update_err": errs[fc1],
                          "zero_grad_biases": len(zero_grad),
                          "zero_grad_update_max": residue}
        print("[module] first fused step vs %s: probabilities within %.3g "
              "(tol %g); %d updates within %.3g of their norm, worst %s "
              "(tol %g); %d within %.3g, worst %s (its own spread %.3g; tol "
              "%g); fc1 %.3g; %d conv biases into BatchNorm (zero "
              "gradient) moved by at most %.3g (tol %g)"
              % (label, perr, PROB_TOL, len(rest), worst, name,
                 R50MOD_UPDATE_TOL, len(loose), worst3, name3,
                 spread[name3], R50MOD_3X3_TOL, errs[fc1], len(zero_grad),
                 residue, R50MOD_ZERO_GRAD_TOL))
        top = sorted(errs, key=errs.get, reverse=True)[:6]
        print("[module]   largest vs %s: %s" % (label, ", ".join(
            "%s %.3g (spread %.3g)" % (k, errs[k], spread[k]) for k in top)))
        check(perr <= PROB_TOL, "first-step probabilities differ from the "
              "%s's by %g" % (label, perr))
        check(worst <= R50MOD_UPDATE_TOL and worst3 <= R50MOD_3X3_TOL
              and residue <= R50MOD_ZERO_GRAD_TOL,
              "first-step updates differ from the %s's: %s" % (label,
                                                              results[label]))
    fc1_move = float(np.abs(w_gpu[fc1] - w0[fc1]).max())
    print("[module] fc1 (%s) moved by up to %.4g on the card, %.4g on the "
          "CPU (CPU step %.1f s)" % (fc1, fc1_move,
                                     float(np.abs(w_cpu[fc1] - w0[fc1]).max()),
                                     cpu_s))
    check(fc1_move > 1e-4, "fc1's update is %g: SoftmaxOutput's gradient "
          "did not reach it" % fc1_move)

    # fit -> Module.load -> score / predict
    rs = np.random.RandomState(R50MOD["fit_seed"])
    X = rs.uniform(size=(R50MOD["fit_rows"], 3, 224, 224)).astype(np.float32)
    Y = rs.randint(0, R50MOD["classes"], R50MOD["fit_rows"]) \
        .astype(np.float32)
    it = mx.io.PrefetchingIter(
        mx.io.NDArrayIter(X, Y, batch_size=R50MOD["batch"], ctx=cpu()),
        device=gpu(0))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    prefix = os.path.join(tmp, "r50")
    fmod = r50_module(gpu(0), w0, a0)
    seen = []
    t0 = time.perf_counter()
    fmod.fit(it, num_epoch=1, eval_metric=["acc", "ce"],
             optimizer_params={"learning_rate": R50MOD["lr"],
                               "momentum": R50MOD["momentum"]},
             batch_end_callback=[mx.callback.Speedometer(R50MOD["batch"], 2),
                                 lambda p: seen.append(p.nbatch)],
             epoch_end_callback=mx.callback.do_checkpoint(prefix))
    fit_s = time.perf_counter() - t0
    check(seen == [0, 1, 2, 3], "fit ran batches %s, expected 4" % seen)
    fmod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    trained = fmod.score(it, ["acc", "ce"])
    lmod = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                              context=[gpu(0)])
    B = R50MOD["batch"]
    lmod.bind(data_shapes=[("data", (B, 3, 224, 224))],
              label_shapes=[("softmax_label", (B,))])
    lmod.init_optimizer(kvstore="local", optimizer="sgd",
                        optimizer_params={"learning_rate": R50MOD["lr"],
                                          "momentum": R50MOD["momentum"]})
    slots = sorted(fmod._updater.states)
    state_err = max(float(np.abs(fmod._updater.states[k].asnumpy()
                                 - lmod._updater.state(
                                     k, lmod._exec_group.param_arrays[k][0])
                                 .asnumpy()).max()) for k in slots)
    loaded = lmod.score(it, ["acc", "ce"])
    preds = lmod.predict(it).asnumpy()
    rows = float(np.abs(preds.sum(axis=1) - 1.0).max())
    print("[module] fit: 1 epoch of %d batches in %.2f s; trained %s; "
          "loaded %s (%d optimizer states within %.3g); predict %s, rows "
          "sum to 1 within %.3g" % (len(seen), fit_s, trained, loaded,
                                    len(slots), state_err, preds.shape,
                                    rows))
    check(len(slots) == 193 and state_err == 0.0,
          "loaded optimizer states differ by %g" % state_err)
    check(trained[0][0] == loaded[0][0] == "accuracy"
          and trained[0][1] == loaded[0][1]
          and abs(trained[1][1] - loaded[1][1]) <= 1e-5 * abs(trained[1][1]),
          "the loaded Module scores %s, the trained one %s"
          % (loaded, trained))
    check(preds.shape == (R50MOD["fit_rows"], R50MOD["classes"])
          and rows <= 1e-5, "predict gave %s with rows off 1 by %g"
          % (preds.shape, rows))
    it.close()
    del fmod, lmod
    torch.cuda.empty_cache()
    return launches, {
        "images_per_s": ips, "step_ms": step_ms,
        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
        "first_step_ms": first_s * 1e3, "profile": profile, "vs": results,
        "cpu_step_s": cpu_s,
        "fc1_update_max": fc1_move, "fit_s": fit_s,
        "score": [(n, float(v)) for n, v in trained],
        "loaded_score": [(n, float(v)) for n, v in loaded],
        "phase_s": time.perf_counter() - t_phase}


# --------------------------------------------------------------------------
# bf16 mixed precision: bench.py main() on its accelerator (phase 14) and
# bench.py --bf16 (phase 15)
# first bf16 step, card vs CPU: each value (the loss, every trained
# parameter's update in norm) within max(BF16_BAND_FACTOR x its own bf16
# band, BF16_FLOOR), the band being its distance between the card's bf16
# and fp32 steps, measured in the phase: the two bf16 runs round at the
# same places but sum in other orders, so they differ by less than bf16
# does from fp32; the floor is bf16's relative step, 2^-7
BF16_BAND_FACTOR = 2.0
BF16_FLOOR = 2.0 ** -7
BF16_CPU_STEP_LIMIT_S = 60.0
BF16_CPU_BATCH = 8


def _update_norm_errs(got, want, w0):
    """Each parameter's update against another update, in norm: {name:
    ||(got - w0) - (want - w0)|| / ||want - w0||}."""
    return {k: float(np.linalg.norm((got[k] - w0[k]) - (want[k] - w0[k]))
                     / max(np.linalg.norm(want[k] - w0[k]), 1e-30))
            for k in w0}


def _count_nhwc_copies(step):
    """One call of ``step`` with ``hopper_conv``'s NHWC conversions counted:
    {"1x1" or "3x3": [conversions, copies made, bytes copied]} (a channels-
    last tensor converts without a copy)."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    counts = {"1x1": [0, 0, 0], "3x3": [0, 0, 0]}
    where = ["3x3"]
    nhwc, bwd = hc._nhwc, hc._Conv1x1.backward

    def counted(x):
        out = nhwc(x)
        c = counts[where[0]]
        c[0] += 1
        if out.data_ptr() != x.data_ptr():
            c[1] += 1
            c[2] += out.numel() * out.element_size()
        return out

    def backward_1x1(ctx, g):
        where[0] = "1x1"
        try:
            return bwd(ctx, g)
        finally:
            where[0] = "3x3"

    hc._nhwc, hc._Conv1x1.backward = counted, staticmethod(backward_1x1)
    try:
        step()
        torch.cuda.synchronize()
    finally:
        hc._nhwc, hc._Conv1x1.backward = nhwc, staticmethod(bwd)
    return counts


def _zero_grad_biases_gluon():
    """The conv biases of the Gluon resnet50_v1 that feed only a BatchNorm
    (zero gradient: BatchNorm subtracts the batch mean)."""
    from mxnet_tpu_torch import name, symbol
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with name.NameManager():
        out = vision.resnet50_v1()(symbol.var("data"))
    return _biases_into_batchnorm(out)


def _ft_first_step(ctx, batch, dtype):
    """The first FusedTrainer step of the seeded full-width net at
    ``batch``: (loss, trained fp32 masters, initial weights, seconds)."""
    from mxnet_tpu_torch.fused import FusedTrainer
    net, x, y = gluon_resnet50(ctx, batch)
    net(x).wait_to_read()
    w0 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    ft = FusedTrainer(net, "softmax_cross_entropy", "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9}, dtype=dtype)
    t0 = time.perf_counter()
    loss = float(ft.step(x, y).asnumpy())
    seconds = time.perf_counter() - t0
    ft.sync_params()
    w1 = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    return loss, w1, w0, seconds


def phase_bf16_training(card, fp32_ips):
    """Phase 14: bench.py main()'s accelerator run, Gluon ``resnet50_v1``
    (224 px, 1,000 classes) trained by ``FusedTrainer(dtype="bfloat16")``
    at batch 128 (SGD lr 0.1, momentum 0.9) on gpu(0): the launch counters,
    zeroed just before the first step and read after the last timed one,
    must read 32 launches of kernel 1's bf16 kernel, 16 of kernel 2's bf16
    partial pass with the bf16 plan's reductions (16 on 132 SMs), none of
    their fp32 kernels, and 36 of kernel 12's partial pass with its
    reductions a step; the masters stay fp32 and
    the loss finite and falling.  The first step at batch 8 (4 if the CPU
    step takes over 60 s) against the CPU from the same fp32 weights: the
    loss, every trained parameter's update and the whole update (by norm)
    each within max(2 x its own bf16 band, 2^-7), the band being its
    distance between the card's bf16 and fp32 steps, measured here; the
    conv biases that feed only a BatchNorm (zero gradient) and the running
    statistics are left out."""
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.fused import FusedTrainer
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    net, x, y = gluon_resnet50(gpu(0), BF16_BATCH)
    net(x).wait_to_read()
    ft = FusedTrainer(net, "softmax_cross_entropy", "sgd",
                      {"learning_rate": 0.1, "momentum": 0.9},
                      dtype="bfloat16")
    print("[bf16-training] resnet50_v1 at batch %d, FusedTrainer bf16, made "
          "in %.2f s" % (BF16_BATCH, time.perf_counter() - t0))
    _zero_conv_counts(hc)
    hc.conv1x1_wgrad_launches = hc.conv1x1_wgrad_reduce_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(ft.step(x, y).asnumpy())]
    first_s = time.perf_counter() - t0
    times = timed_steps(lambda: ft.step(x, y),
                        lambda loss: losses.append(float(loss.asnumpy())))
    steps = 1 + WARMUP_STEPS + TIMED_STEPS
    launches = dict(_conv_counts(hc), **{
        "conv1x1_wgrad": hc.conv1x1_wgrad_launches,
        "conv1x1_wgrad reduction": hc.conv1x1_wgrad_reduce_launches})
    want = dict(bf16_step_counts(BF16_BATCH), **{
        "conv1x1_wgrad": 36,
        "conv1x1_wgrad reduction": w1x1_reductions_per_step(BF16_BATCH)})
    print("[bf16-training] %d steps ran %s launches (per step %s; expected "
          "%s)" % (steps, launches, {k: v / steps for k, v in
                                      launches.items()}, want))
    check(all(launches[k] == want[k] * steps for k in want),
          "bf16 launch counts %s over %d steps, expected %s per step"
          % (launches, steps, want))
    masters = {str(v.dtype) for v in ft._args.values()}
    check(masters == {"torch.float32"}, "FusedTrainer's masters are %s"
          % masters)
    check(all(math.isfinite(v) for v in losses) and min(losses[1:])
          < losses[0], "bf16 losses do not fall or are not finite: %s"
          % losses)
    step_ms = float(np.median(times)) * 1e3
    ips = BF16_BATCH / (step_ms / 1e3)
    print("[bf16-training] batch %d bf16, first step %.1f ms, then %d timed "
          "steps: median %.2f ms (min %.2f, max %.2f), %.1f train images/s "
          "(phase 5's fp32 at batch %d: %.1f) on %s; losses %s"
          % (BF16_BATCH, first_s * 1e3, TIMED_STEPS, step_ms,
             min(times) * 1e3, max(times) * 1e3, ips, BATCH, fp32_ips, card,
             ["%.4f" % v for v in losses]))
    profile = phase_training_profile(
        card, lambda: ft.step(x, y), step_ms, "bf16-profile", BF16_BATCH,
        (36, w1x1_reductions_per_step(BF16_BATCH)), bf16=True)
    copies = _count_nhwc_copies(lambda: ft.step(x, y))
    profile["nhwc_copies"] = copies
    print("[bf16-profile] NHWC conversions in one step (calls, copies, MB): "
          "1x1 backward %d, %d, %.1f; 3x3 %d, %d, %.1f"
          % (copies["1x1"][0], copies["1x1"][1], copies["1x1"][2] / 1e6,
             copies["3x3"][0], copies["3x3"][1], copies["3x3"][2] / 1e6))
    del ft, net, x, y
    torch.cuda.empty_cache()

    # the first step against the CPU, and the width of bf16 on the card
    batch = BF16_CPU_BATCH
    while True:
        loss, w_gpu, w0, _ = _ft_first_step(gpu(0), batch, "bfloat16")
        loss32, w_gpu32, _, _ = _ft_first_step(gpu(0), batch, "float32")
        closs, w_cpu, cw0, cpu_s = _ft_first_step(cpu(), batch, "bfloat16")
        if cpu_s <= BF16_CPU_STEP_LIMIT_S or batch == 4:
            break
        print("[bf16-training] the CPU step took %.1f s at batch %d; cutting "
              "the batch to 4" % (cpu_s, batch))
        batch = 4
    check(all(np.array_equal(w0[k], cw0[k]) for k in w0),
          "the card's and the CPU's nets start from different weights")
    zero_grad = _zero_grad_biases_gluon()
    trained = {k: v for k, v in w0.items()
               if "running_" not in k and k not in zero_grad}
    band = _update_norm_errs(w_gpu, w_gpu32, trained)
    errs = _update_norm_errs(w_gpu, w_cpu, trained)
    tols = {k: max(BF16_BAND_FACTOR * band[k], BF16_FLOOR) for k in trained}
    worst = max(errs, key=lambda k: errs[k] / tols[k])
    rel_loss = abs(loss - closs) / abs(closs)
    loss_band = abs(loss - loss32) / abs(loss32)
    loss_tol = max(BF16_BAND_FACTOR * loss_band, BF16_FLOOR)
    residue = max(float(np.abs(w[k] - w0[k]).max())
                  for w in (w_gpu, w_cpu) for k in zero_grad)
    # the whole model's update, all trained parameters as one vector
    flat = {name: np.concatenate([(w[k] - w0[k]).ravel() for k in trained])
            for name, w in (("gpu", w_gpu), ("gpu32", w_gpu32),
                            ("cpu", w_cpu))}
    agg_band = float(np.linalg.norm(flat["gpu"] - flat["gpu32"])
                     / np.linalg.norm(flat["gpu32"]))
    agg_err = float(np.linalg.norm(flat["gpu"] - flat["cpu"])
                    / np.linalg.norm(flat["cpu"]))
    agg_tol = max(BF16_BAND_FACTOR * agg_band, BF16_FLOOR)
    print("[bf16-training] first bf16 step at batch %d vs the CPU (plain "
          "versions, %.1f s): loss %.6f vs %.6f (rel %.3g; bf16 vs fp32 on "
          "the card %.3g, tol %.3g); %d trained updates, each within its "
          "tol max(%g x its bf16 band, %g): worst %s at %.3g of its norm "
          "(band %.3g, tol %.3g); median update error %.3g, median band "
          "%.3g; the whole update within %.3g of its norm (band %.3g, tol "
          "%.3g); %d conv biases into BatchNorm (zero gradient) moved by at "
          "most %.3g" % (batch, cpu_s, loss, closs, rel_loss, loss_band,
                         loss_tol, len(trained), BF16_BAND_FACTOR,
                         BF16_FLOOR, worst, errs[worst], band[worst],
                         tols[worst], float(np.median(list(errs.values()))),
                         float(np.median(list(band.values()))), agg_err,
                         agg_band, agg_tol, len(zero_grad), residue))
    check(rel_loss <= loss_tol, "bf16 first-step loss differs from the "
          "CPU's by %g > %g" % (rel_loss, loss_tol))
    check(errs[worst] <= tols[worst], "the bf16 update of %s differs from "
          "the CPU's by %g of its norm > %g" % (worst, errs[worst],
                                               tols[worst]))
    check(agg_err <= agg_tol, "the bf16 step's whole update differs from "
          "the CPU's by %g of its norm > %g" % (agg_err, agg_tol))
    torch.cuda.empty_cache()
    return launches, {
        "batch": BF16_BATCH, "images_per_s": ips, "step_ms": step_ms,
        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
        "first_step_ms": first_s * 1e3, "losses": losses,
        "fp32_batch32_images_per_s": fp32_ips, "profile": profile,
        "cpu_check": {"batch": batch, "loss_rel_err": rel_loss,
                      "loss_band": loss_band, "loss_tol": loss_tol,
                      "worst_param": worst, "worst_err": errs[worst],
                      "worst_band": band[worst], "worst_tol": tols[worst],
                      "update_err_median": float(np.median(list(
                          errs.values()))),
                      "band_median": float(np.median(list(band.values()))),
                      "update_err_max": max(errs.values()),
                      "whole_update_err": agg_err,
                      "whole_update_band": agg_band,
                      "zero_grad_update_max": residue,
                      "cpu_step_s": cpu_s}}


BF16MOD = dict(batch=128, classes=1000, lr=0.01, momentum=0.9, steps=30,
               init_seed=7, data_seed=3)
BF16_MEM_RATIO = 0.65          # bench.py:600: params + activations


def _bf16_module(ctx, bf16):
    """``bench_bf16``'s Module (bench.py:456-540): ``_multichip_symbol
    ("resnet50")`` at batch 128, bound with ``MXNET_TPU_BF16`` set or
    unset, ``Xavier(gaussian, 2)`` after ``random.seed(7)``, SGD lr 0.01
    momentum 0.9 with ``multi_precision`` in the bf16 run."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with mx.name.NameManager():
        out = vision.resnet50_v1(classes=BF16MOD["classes"])(
            mx.sym.var("data"))
    net = mx.sym.SoftmaxOutput(out, mx.sym.var("softmax_label"),
                               name="softmax")
    mod = mx.mod.Module(net, data_names=("data",),
                        label_names=("softmax_label",), context=[ctx])
    B = BF16MOD["batch"]
    old = os.environ.pop("MXNET_TPU_BF16", None)
    if bf16:
        os.environ["MXNET_TPU_BF16"] = "1"
    try:
        mod.bind(data_shapes=[("data", (B, 3, 224, 224))],
                 label_shapes=[("softmax_label", (B,))])
    finally:
        os.environ.pop("MXNET_TPU_BF16", None)
        if old is not None:
            os.environ["MXNET_TPU_BF16"] = old
    mx.random.seed(BF16MOD["init_seed"])
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", magnitude=2.0))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": BF16MOD["lr"], "momentum": BF16MOD["momentum"],
        "multi_precision": bf16})
    return mod


def _bf16_batch(ctx):
    import mxnet_tpu_torch as mx
    B = BF16MOD["batch"]
    rs = np.random.RandomState(BF16MOD["data_seed"])
    x = rs.uniform(size=(B, 3, 224, 224)).astype(np.float32)
    y = rs.randint(0, BF16MOD["classes"], (B,)).astype(np.float32)
    return mx.io.DataBatch([mx.nd.array(x, ctx)], [mx.nd.array(y, ctx)]), y


def _mean_ce(mod, y):
    p = mod.get_outputs()[0].asnumpy().astype(np.float64)
    rows = p.reshape(len(y), -1)[np.arange(len(y)), y.astype(int)]
    return float(np.mean(-np.log(np.maximum(rows, 1e-30))))


def _bf16_run(bf16, card, keep=False):
    """One run of bench_bf16: 30 steps on the repeated batch (the mean
    cross-entropy of each step's own softmax output), the third step's
    memory, and 2 warm-up and 10 timed steps.  With ``keep`` returns the
    trained Module too."""
    import gc
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.ops import hopper_conv as hc
    gc.collect()
    torch.cuda.empty_cache()
    mod = _bf16_module(gpu(0), bf16)
    batch, y = _bf16_batch(gpu(0))
    ex = mod._exec_group.execs[0]
    losses, mem = [], None
    _zero_conv_counts(hc)
    for i in range(BF16MOD["steps"]):
        if i == 2:      # the optimizer states exist from the first update
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        mod.forward_backward(batch)
        mod.update()
        if i == 2:
            torch.cuda.synchronize()
            mem = torch.cuda.max_memory_allocated() - before
        losses.append(_mean_ce(mod, y))
    times = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            times.append(time.perf_counter() - t0)
    counts = _conv_counts(hc)
    steps = BF16MOD["steps"] + WARMUP_STEPS + TIMED_STEPS
    want = bf16_step_counts() if bf16 else {
        "implicit_gemm_conv": 32,
        "implicit_gemm_conv reduction": conv_reductions_per_step(
            BF16MOD["batch"]),
        "taps_conv_bf16": 0, "taps_wgrad": 16,
        "taps_wgrad reduction": wgrad_reductions_per_step(BF16MOD["batch"]),
        "taps_wgrad_bf16": 0, "taps_wgrad_bf16 reduction": 0}
    print("[bf16-module] %s: kernels 1 and 2 launched %s in %d steps "
          "(expected %s a step)" % ("bf16" if bf16 else "fp32", counts,
                                    steps, want))
    check(counts == {k: v * steps for k, v in want.items()},
          "%s Module: kernel 1 and 2 launches %s over %d steps, expected %s "
          "a step" % ("bf16" if bf16 else "fp32", counts, steps, want))
    params = [ex.arg_dict[n]._data for n in mod._param_names]
    dtypes = {str(t.dtype) for t in params if t.dim() == 4}
    masters = {str(st[1]._data.dtype) for st in mod._updater.states.values()
               if isinstance(st, tuple)}
    step_ms = float(np.median(times)) * 1e3
    third = max(1, len(losses) // 3)
    out = {"weight_dtype": sorted(dtypes), "master_dtypes": sorted(masters),
           "conv_launches": counts,
           "params_bytes": sum(t.numel() * t.element_size() for t in params),
           "activations_bytes": mem, "step_ms": step_ms,
           "images_per_s": BF16MOD["batch"] / (step_ms / 1e3),
           "losses": losses,
           "loss_final_mean": float(np.mean(losses[-third:]))}
    print("[bf16-module] %s: conv weights %s, masters %s, params %.1f MB, "
          "step activations peak %.2f GB, median step %.2f ms (%.1f train "
          "images/s) on %s; losses %s"
          % ("bf16" if bf16 else "fp32", out["weight_dtype"],
             out["master_dtypes"], out["params_bytes"] / 1e6, mem / 1e9,
             step_ms, out["images_per_s"], card,
             ["%.4f" % v for v in losses]))
    if keep:
        return out, mod
    del mod, ex, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _one_bf16_step(fused):
    """One bf16 step of bench_bf16's Module on the fused or the eager path:
    host copies of the weights and masters by parameter name."""
    from mxnet_tpu_torch import gpu
    if not fused:
        os.environ["MXNET_TPU_FUSED_STEP"] = "0"
    try:
        mod = _bf16_module(gpu(0), True)
        batch, _ = _bf16_batch(gpu(0))
        mod.forward_backward(batch)
        mod.update()
        check(mod._fused_step.eligible() == fused, "the %s Module took the "
              "other path" % ("fused" if fused else "eager"))
    finally:
        os.environ.pop("MXNET_TPU_FUSED_STEP", None)
    ex = mod._exec_group.execs[0]
    weights = {n: ex.arg_dict[n]._data.cpu() for n in mod._param_names}
    masters = {n: mod._updater.states[i][1]._data.cpu()
               for i, n in enumerate(mod._param_names)
               if isinstance(mod._updater.states[i], tuple)}
    del mod, ex, batch
    torch.cuda.empty_cache()
    return weights, masters


def phase_bf16_module(card):
    """Phase 15: bench.py --bf16 (``bench_bf16``) on one H100: fp32, then
    bf16 (``MXNET_TPU_BF16=1``, multi-precision SGD), from one seed, 30
    steps each on the repeated batch at lr 0.01 (the bf16 Module, trained,
    is returned beside the summary for phase 16), with bench.py's three
    checks: both curves descend by max(0.05, 2%) of their first loss and
    bf16's final-third mean stays within the fp32 tail's maximum + max(0.15,
    10% of the fp32 final mean) (bench.py:583-598); parameter bytes plus
    the step's peak activation bytes at bf16 <= 0.65x fp32's; bf16 weights
    under the flag, fp32 without, fp32 masters.  Then one bf16 step fused
    and one eager (``MXNET_TPU_FUSED_STEP=0``), with cuDNN's deterministic
    algorithms so that both see the same gradients: the masters and the
    bf16 weights must be bit-equal."""
    t_phase = time.perf_counter()
    r32 = _bf16_run(False, card)
    r16, mod16 = _bf16_run(True, card, keep=True)
    check(r32["weight_dtype"] == ["torch.float32"]
          and r16["weight_dtype"] == ["torch.bfloat16"]
          and r16["master_dtypes"] == ["torch.float32"]
          and r32["master_dtypes"] == [],
          "weight dtypes fp32 %s, bf16 %s, masters %s"
          % (r32["weight_dtype"], r16["weight_dtype"], r16["master_dtypes"]))
    tail32 = r32["losses"][len(r32["losses"]) // 2:]
    band_hi = max(tail32) + max(0.15, 0.1 * max(abs(r32["loss_final_mean"]),
                                                1e-6))
    descended = {name: min(r["losses"]) <= r["losses"][0]
                 - max(0.05, 0.02 * abs(r["losses"][0]))
                 for name, r in (("fp32", r32), ("bf16", r16))}
    pa32 = r32["params_bytes"] + r32["activations_bytes"]
    pa16 = r16["params_bytes"] + r16["activations_bytes"]
    ratio = pa16 / pa32
    print("[bf16-module] convergence: descended %s; bf16 final-third mean "
          "%.4f <= %.4f (fp32 tail max + band; fp32 final-third mean %.4f); "
          "params + activations %.2f GB (bf16) / %.2f GB (fp32) = %.3f (<= "
          "%g); %.1f vs %.1f train images/s"
          % (descended, r16["loss_final_mean"], band_hi,
             r32["loss_final_mean"], pa16 / 1e9, pa32 / 1e9, ratio,
             BF16_MEM_RATIO, r16["images_per_s"], r32["images_per_s"]))
    check(all(descended.values()), "a loss curve did not descend: %s"
          % descended)
    check(r16["loss_final_mean"] <= band_hi, "bf16 ends at %.4f, above the "
          "fp32 band %.4f" % (r16["loss_final_mean"], band_hi))
    check(ratio <= BF16_MEM_RATIO, "bf16 params + activations are %.3f of "
          "fp32's > %g" % (ratio, BF16_MEM_RATIO))

    torch.backends.cudnn.deterministic = True
    try:
        wf, mf = _one_bf16_step(True)
        we, me = _one_bf16_step(False)
    finally:
        torch.backends.cudnn.deterministic = False
    differ = [n for n in wf if not torch.equal(wf[n], we[n])]
    differ_m = [n for n in mf if not torch.equal(mf[n], me[n])]
    print("[bf16-module] one bf16 step fused vs eager: %d weights (%s) and "
          "%d masters bit-equal; %d weights, %d masters differ"
          % (len(wf) - len(differ), sorted({str(t.dtype) for t in
                                           wf.values()}),
             len(mf) - len(differ_m), len(differ), len(differ_m)))
    low = {n for n, t in wf.items() if t.dtype == torch.bfloat16}
    check(set(mf) == low and not differ and not differ_m,
          "fused and eager bf16 steps differ: weights %s, masters %s"
          % (differ[:5], differ_m[:5]))
    return {"fp32": r32, "bf16": r16, "mem_ratio": ratio,
            "band_hi": band_hi, "descended": descended,
            "fused_vs_eager_bit_equal": len(wf),
            "phase_s": time.perf_counter() - t_phase}, mod16


# --------------------------------------------------------------------------
# bf16 inference (phase 16): the eval pass of phase 15's bf16 run
INFER = dict(batches=2, cpu_batch=8, data_seed=3)


def _counts():
    from mxnet_tpu_torch.ops import hopper_block as hb, hopper_conv as hc
    return {"fused_bottleneck": hb.launches,
            "taps_conv_bf16": hc.launches_bf16,
            "implicit_gemm_conv": (hc.launches - hc.launches_bf16
                                   + hc.conv_reduce_launches),
            "taps_wgrad": hc.wgrad_launches + hc.wgrad_reduce_launches,
            "conv1x1_wgrad": (hc.conv1x1_wgrad_launches
                              + hc.conv1x1_wgrad_reduce_launches)}


def _zero_counts():
    from mxnet_tpu_torch.ops import hopper_block as hb, hopper_conv as hc
    hb.launches = 0
    _zero_conv_counts(hc)
    hc.conv1x1_wgrad_launches = hc.conv1x1_wgrad_reduce_launches = 0


def _check_forward_counts(counts, forwards, what):
    want = {"fused_bottleneck": 12 * forwards,
            "taps_conv_bf16": 4 * forwards, "implicit_gemm_conv": 0,
            "taps_wgrad": 0, "conv1x1_wgrad": 0}
    check(counts == want, "%s: %d bf16 forwards launched %s, expected %s"
          % (what, forwards, counts, want))


def _infer_module(ctx, sym, bf16, batch, arg, aux):
    """A Module of ``sym`` bound for inference at ``batch`` (bf16 under
    ``MXNET_TPU_BF16``, read at bind) with the given parameters."""
    import mxnet_tpu_torch as mx
    labels = "softmax_label" in sym.list_arguments()
    mod = mx.mod.Module(sym, data_names=("data",),
                        label_names=("softmax_label",) if labels else None,
                        context=[ctx])
    old = os.environ.pop("MXNET_TPU_BF16", None)
    if bf16:
        os.environ["MXNET_TPU_BF16"] = "1"
    try:
        mod.bind(data_shapes=[("data", (batch, 3, 224, 224))],
                 label_shapes=([("softmax_label", (batch,))] if labels
                               else None), for_training=False)
    finally:
        os.environ.pop("MXNET_TPU_BF16", None)
        if old is not None:
            os.environ["MXNET_TPU_BF16"] = old
    mod.set_params(arg, aux, allow_extra=True)
    return mod


def _logits_symbol(mod):
    """The logits under a Module's SoftmaxOutput: the final Dense's
    output."""
    internals = mod.symbol.get_internals()
    name = [n for n in internals.list_outputs() if "dense" in n][-1]
    return internals[name]


def _infer_group(name: str) -> str:
    lname = name.lower()
    if "fused_bottleneck_kernel" in name:
        return "kernel 13 (fused bottleneck)"
    if "taps_conv_bf16_kernel" in name:
        return "kernel 1 bf16 (3x3 of the projection units)"
    if "taps_conv_kernel" in name:
        return "kernel 1 fp32 (3x3 of the projection units)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    if "copy" in lname or "nchwtonhwc" in lname or "nhwctonchw" in lname:
        return "layout and dtype copies"
    if any(k in lname for k in ("conv", "gemm", "xmma", "cudnn", "cutlass",
                                "sm80_", "sm90_")):
        return "cuDNN/cuBLAS (7x7 stem, 1x1s, fc)"
    return "BN and elementwise"


def _inference_profile(card, forward, fwd_ms, tag="bf16-infer-profile"):
    """Device time by group over 2 forwards (torch.profiler), the idle
    share against the median unprofiled forward."""
    n = 2
    kernels, _ = profiled_kernels(forward, n, tag)
    groups, counts = {}, {}
    for e in kernels:
        g = _infer_group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
        counts[g] = counts.get(g, 0) + 1
    device_ms = sum(groups.values()) / n / 1e3
    check(device_ms > 0, "the profiler recorded no device time")
    check(counts.get("kernel 13 (fused bottleneck)", 0) == 12 * n,
          "the profile saw %s kernel-13 launches in %d forwards"
          % (counts.get("kernel 13 (fused bottleneck)"), n))
    k1 = (counts.get("kernel 1 bf16 (3x3 of the projection units)", 0),
          counts.get("kernel 1 fp32 (3x3 of the projection units)", 0))
    check(k1 == (4 * n, 0), "the profile saw %d bf16 and %d fp32 kernel-1 "
          "launches in %d forwards" % (k1 + (n,)))
    idle = max(0.0, 1 - device_ms / fwd_ms)
    print("[%s] one batch-%d forward: %.2f ms device busy, %.2f ms wall "
          "unprofiled (%.1f%% idle), %d launches on %s"
          % (tag, BF16MOD["batch"], device_ms, fwd_ms, 100 * idle,
             sum(counts.values()) // n, card))
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[%s]   %-40s %8.3f ms/forward (%.1f%%), %4d launches"
              % (tag, g, us / n / 1e3, 100.0 * us / n / 1e3 / device_ms,
                 counts[g] // n))
    return {"forward_device_ms": device_ms, "idle_share": idle,
            "device_ms_by_group": {g: us / n / 1e3 for g, us in
                                   groups.items()},
            "launches_by_group": {g: c // n for g, c in counts.items()}}


def _timed_forwards(mod, batch):
    """Median ms of 10 forwards after 2 warm-ups, each ending in
    ``torch.cuda.synchronize()``."""
    times = []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward(batch, is_train=False)
        mod.get_outputs()[0].wait_to_read()
        torch.cuda.synchronize()
        if i >= WARMUP_STEPS:
            times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_bf16_inference(card, mod16):
    """Phase 16: bf16 inference of full-width ResNet-50 v1 through
    ``Module``, the eval pass of phase 15's bf16 run.  ``predict`` over an
    ``NDArrayIter`` of 2 batches of 128 from ``RandomState(3)`` and
    ``score`` with ``Accuracy`` on phase 15's trained bf16 Module, the
    counters zeroed just before and read just after (12 kernel-13 and 4
    kernel-1 launches a forward, no kernel 2 or 12); the same weights
    (bf16 values, exact in fp32) and moving statistics in an fp32 Module
    bound for inference measure the bf16 band on the logits (norm of the
    difference over the fp32 norm) and the share of matching top-1; at
    batch 8 the same weights on the CPU (plain arms, kernel 13's included)
    give bf16 logits within twice that band of the card's.  bf16 and fp32
    inference images/s (median of 10 forwards after 2 warm-ups), a
    profile of the bf16 forward by group with its idle share, and the
    one-off folding time of the 12 blocks after a weight change."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch import weights as wmod
    t_phase = time.perf_counter()
    B, n = BF16MOD["batch"], INFER["batches"]
    rs = np.random.RandomState(INFER["data_seed"])
    X = rs.uniform(size=(n * B, 3, 224, 224)).astype(np.float32)
    Y = rs.randint(0, BF16MOD["classes"], (n * B,)).astype(np.float32)
    it = mx.io.NDArrayIter(X, Y, batch_size=B, ctx=gpu(0))
    ex = mod16._exec_group.execs[0]
    check(ex._plan(False).n_fused == 12, "the bf16 inference plan fused %d "
          "blocks, expected 12" % ex._plan(False).n_fused)

    # the main path: the counts zeroed just before, read just after
    _zero_counts()
    t0 = time.perf_counter()
    probs16 = mod16.predict(it).asnumpy()
    score = dict(mod16.score(it, "acc"))
    path_s = time.perf_counter() - t0
    path_counts = _counts()
    _check_forward_counts(path_counts, 2 * n, "predict + score")
    check(probs16.shape == (n * B, BF16MOD["classes"])
          and np.isfinite(probs16).all()
          and np.allclose(probs16.sum(1), 1.0, atol=1e-3),
          "bf16 predict gave %s" % (probs16.shape,))
    acc_pred = float(np.mean(probs16.argmax(1) == Y))
    check(abs(score["accuracy"] - acc_pred) < 1e-9, "score %s against "
          "predict's accuracy %g" % (score, acc_pred))
    print("[bf16-infer] predict + score over %d batches of %d in %.2f s: "
          "probabilities %s, accuracy %.4f; launches %s on %s"
          % (n, B, path_s, probs16.shape, score["accuracy"], path_counts,
             card))

    arg, aux = mod16.get_params()
    mod32 = _infer_module(gpu(0), mod16.symbol, False, B, arg, aux)
    check(str(mod32._exec_group.execs[0].arg_dict[
        mod16._param_names[0]]._data.dtype) == "torch.float32",
        "the fp32 Module bound bf16 weights")
    probs32 = mod32.predict(it).asnumpy()
    logits = {}
    for bf16 in (True, False):
        lm = _infer_module(gpu(0), _logits_symbol(mod16), bf16, B, arg, aux)
        logits[bf16] = lm.predict(it).asnumpy().astype(np.float64)
        del lm
    band = float(np.linalg.norm(logits[True] - logits[False])
                 / np.linalg.norm(logits[False]))
    top1 = float(np.mean(logits[True].argmax(1) == logits[False].argmax(1)))
    print("[bf16-infer] bf16 against fp32 on the same weights: logits "
          "within %.4g of the fp32 norm, top-1 equal in %.4f of %d rows, "
          "probabilities max |dp| %.3g" % (band, top1, n * B,
                                           float(np.abs(probs16 - probs32)
                                                 .max())))
    check(0 < band < 0.1 and top1 > 0.5, "bf16 band %g, top-1 share %g"
          % (band, top1))

    # the CPU at batch 8, the same weights, plain arms
    Bc = INFER["cpu_batch"]
    carg = {k: mx.nd.NDArray(v._data.cpu()) for k, v in arg.items()}
    caux = {k: mx.nd.NDArray(v._data.cpu()) for k, v in aux.items()}
    cmod = _infer_module(cpu(), _logits_symbol(mod16), True, Bc, carg, caux)
    t0 = time.perf_counter()
    cpu_logits = cmod.predict(mx.io.NDArrayIter(X[:Bc], batch_size=Bc,
                                                ctx=cpu())).asnumpy()
    cpu_s = time.perf_counter() - t0
    card16, card32 = logits[True][:Bc], logits[False][:Bc]
    cpu_err = float(np.linalg.norm(cpu_logits - card16)
                    / np.linalg.norm(card32))
    print("[bf16-infer] the CPU's bf16 logits at batch %d (%.1f s) against "
          "the card's: %.4g of the fp32 norm (tol 2 x band = %.4g)"
          % (Bc, cpu_s, cpu_err, 2 * band))
    check(cpu_err <= 2 * band, "the CPU's bf16 logits differ from the "
          "card's by %g > 2 x %g" % (cpu_err, band))
    del cmod, carg, caux

    # images/s: the batch on the card, forwards timed, counters per forward
    batch = mx.io.DataBatch([mx.nd.array(X[:B], gpu(0))],
                            [mx.nd.array(Y[:B], gpu(0))])
    folds = []
    real_fold = wmod.fold_bottleneck
    wmod.fold_bottleneck = lambda *a, **k: folds.append(1) or real_fold(*a,
                                                                         **k)
    try:
        mod16.forward(batch, is_train=False)
        torch.cuda.synchronize()
        folds.clear()
        _zero_counts()
        ms16 = _timed_forwards(mod16, batch)
        _check_forward_counts(_counts(), WARMUP_STEPS + TIMED_STEPS,
                              "timed forwards")
    finally:
        wmod.fold_bottleneck = real_fold
    check(not folds, "the timed forwards folded %d blocks: the cache missed"
          % len(folds))
    ms32 = _timed_forwards(mod32, batch)
    ips16, ips32 = B / ms16 * 1e3, B / ms32 * 1e3
    print("[bf16-infer] batch-%d forward: bf16 %.2f ms (%.1f images/s), "
          "fp32 %.2f ms (%.1f images/s), %.2fx on %s"
          % (B, ms16, ips16, ms32, ips32, ms32 / ms16, card))
    profile = _inference_profile(card, lambda: (
        mod16.forward(batch, is_train=False),
        mod16.get_outputs()[0].wait_to_read()), ms16)

    # the folding a weight change costs: the 12 blocks folded again
    fused = [st[2] for st in ex._plan(False).steps
             if hasattr(st[2], "_folded")]
    values = ex._values()
    names = {id(node): node.name for node in mod16.symbol._topo()
             if node.is_var}
    fold_inputs = [[values[names[e[0]]] for e in f.params] for f in fused]
    fold_ms = time_ms(lambda: [real_fold(*f._fold_args(p))
                               for f, p in zip(fused, fold_inputs)],
                      iters=5, warmup=1)
    print("[bf16-infer] folding the 12 blocks after a weight change: %.3f "
          "ms; none in the timed forwards (cached)" % fold_ms)
    del mod32
    torch.cuda.empty_cache()
    return path_counts, {
        "accuracy": score["accuracy"], "band": band, "top1_share": top1,
        "cpu_err": cpu_err, "bf16_forward_ms": ms16, "fp32_forward_ms": ms32,
        "bf16_images_per_s": ips16, "fp32_images_per_s": ips32,
        "fold_ms": fold_ms, "profile": profile,
        "phase_s": time.perf_counter() - t_phase}


# --------------------------------------------------------------------------
# the bucketed LSTM LM (phase 17): example/rnn/bucketing/lstm_bucketing.py's
# model at the LM's width (bench.py's bench_lstm_lm: vocab 33,278, embed =
# hidden = 650, 2 layers, batch 128, fp32, no dropout), the example's
# buckets, Adam and initializer, on its synthetic corpus.  Adam's rate is
# 0.001, not the example's 0.01 (set for vocab 64): at this vocabulary 0.01
# took the epoch's per-token perplexity from 33,276 to 166,745 on an H100
# at 700 W (PERF.md), while 0.001 ends the epoch below its first batch's
BUCKET = dict(vocab=33278, hidden=650, layers=2, batch=128,
              buckets=(10, 20, 30, 40), lr=0.001, sentences=2200,
              corpus_seed=0, timed_steps=5)
BUCKET_UPDATE_TOL = 0.01   # the first T-10 batch's updates, card vs CPU


def bucket_corpus(n, vocab_size, seed=0):
    """The example's ``synthetic_corpus`` (lstm_bucketing.py:51-62): a
    Markov 'language', next = (3 * prev + 1) % V with 10% noise, lengths
    8, 15, 25 and 35 (one bucket each)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = int(rng.choice([8, 15, 25, 35]))
        s = [int(rng.randint(1, vocab_size))]
        for _ in range(ln - 1):
            s.append((3 * s[-1] + 1) % vocab_size if rng.rand() < 0.9
                     else int(rng.randint(1, vocab_size)))
        out.append(s)
    return out


def bucket_sym_gen(mx):
    """The example's ``make_sym_gen`` (lstm_bucketing.py:68-92) at
    ``BUCKET``'s width, through the port's symbols."""
    sym = mx.sym
    V, H, L, B = (BUCKET[k] for k in ("vocab", "hidden", "layers", "batch"))

    def sym_gen(seq_len):
        data = sym.var("data")
        label = sym.var("softmax_label")
        embed = sym.Embedding(data, input_dim=V, output_dim=H, name="embed")
        tnc = sym.transpose(embed, axes=(1, 0, 2))
        init = sym.zeros(shape=(L, B, H))
        out = sym.RNN(tnc, sym.var("lstm_parameters"), init, init,
                      state_size=H, num_layers=L, mode="lstm", name="lstm")
        out = sym.transpose(out, axes=(1, 0, 2))
        pred = sym.FullyConnected(sym.Reshape(out, shape=(-1, H)),
                                  num_hidden=V, name="pred")
        out = sym.SoftmaxOutput(pred, sym.Reshape(label, shape=(-1,)),
                                name="softmax", normalization="batch")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def _bucket_initializer(mx):
    """The example's initializer (lstm_bucketing.py:128-133)."""
    init = mx.init
    return init.Mixed(
        [".*lstm_parameters", ".*"],
        [init.FusedRNN(init.Xavier(factor_type="in", magnitude=2.34),
                       BUCKET["hidden"], BUCKET["layers"], "lstm"),
         init.Xavier(factor_type="in", magnitude=2.34)])


def _bucket_ce(probs, label):
    """Mean -log p(label) over every row of ``probs`` (B·T, V), padding
    included, as SoftmaxOutput's gradient counts them, in fp64."""
    lab = label.reshape(-1).long()
    picked = probs.reshape(-1, probs.shape[-1]).gather(1, lab[:, None])
    return float(-torch.log(picked.double().clamp_min(1e-30)).mean())


def _bucket_cpu_step(mx, snap):
    """The captured T-10 batch's training step on the CPU (plain versions)
    from the card's weights and Adam states before it: (loss, updates)."""
    from mxnet_tpu_torch import cpu
    B, T = BUCKET["batch"], 10
    sym, dn, ln = bucket_sym_gen(mx)(T)
    mod = mx.mod.Module(sym, dn, ln, context=[cpu()])
    mod.bind([mx.io.DataDesc("data", (B, T))],
             [mx.io.DataDesc("softmax_label", (B, T))])
    mod.init_params(arg_params={k: mx.nd.array(v, cpu())
                                for k, v in snap["before"].items()})
    mod.init_optimizer(kvstore="local", optimizer="adam",
                       optimizer_params={"learning_rate": BUCKET["lr"],
                                         "wd": 0.0})
    mod._updater.set_states(snap["states"])
    mod._optimizer._index_update_count = dict(snap["counts"])
    batch = mx.io.DataBatch([mx.nd.array(snap["data"], cpu())],
                            [mx.nd.array(snap["label"], cpu())])
    t0 = time.perf_counter()
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    loss = _bucket_ce(mod.get_outputs()[0]._data,
                    torch.from_numpy(snap["label"]))
    after = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return loss, {k: after[k] - snap["before"][k] for k in after}, \
        time.perf_counter() - t0


def _bucket_group(name: str) -> str:
    g = _lm_group(name)
    if g == "dropout and elementwise":
        return "elementwise (Adam, SoftmaxOutput, transposes)"
    return "optimizer" if g.startswith("optimizer") else g


def phase_bucketing(card):
    """Phase 17: the bucketed LSTM LM at the LM's full width through
    ``BucketingModule`` and ``BucketSentenceIter`` on gpu(0): one ``fit``
    epoch with the example's ``Mixed``/``FusedRNN`` initializer, Adam lr
    0.01 and ``Perplexity(ignore_label=0)``, then ``score``.  The counters,
    zeroed just before ``fit`` and read just after, must read 2 + 2
    launches of kernels 8 and 9 a batch, and ``score`` 2 of kernel 8 a
    batch; every bucket's parameters are the default bucket's tensors
    (same ``data_ptr``); the last batches' loss is below the first
    batch's, and the score's perplexity below the first batch's; the
    first T-10 batch's loss and Adam updates match the CPU's
    from the same weights, Adam states and batch.  Then step ms and
    tokens/s per bucket, the time of a bucket switch and of a bucket's
    first bind, and a two-step profile of a T-40 batch."""
    import random as pyrandom
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.ops import hopper_rnn as hr
    fp32_exact()
    t_phase = time.perf_counter()
    B = BUCKET["batch"]
    sents = bucket_corpus(BUCKET["sentences"], BUCKET["vocab"],
                          BUCKET["corpus_seed"])
    np.random.seed(SEED)
    pyrandom.seed(SEED)
    mx.random.seed(SEED)
    it = mx.rnn.BucketSentenceIter(sents, B, buckets=list(BUCKET["buckets"]),
                                   invalid_label=0, ctx=gpu(0))
    bmod = mx.mod.BucketingModule(bucket_sym_gen(mx),
                                  default_bucket_key=it.default_bucket_key,
                                  context=[gpu(0)])

    # hooks on this instance: the first T-10 training batch (weights and
    # Adam states before it, its batch, its loss and the weights after
    # it), each batch's key, each first bind's and switch's host time
    snap, keys, switches, one_per_bucket, losses = {}, [], [], {}, []
    forward, update, switch = bmod.forward, bmod.update, bmod.switch_bucket

    def hooked_forward(batch, is_train=None):
        if is_train:
            keys.append(batch.bucket_key)
            one_per_bucket.setdefault(batch.bucket_key, batch)
            if batch.bucket_key == 10 and not snap:
                upd = bmod._curr_module._updater
                snap.update(
                    before={k: v.asnumpy()
                            for k, v in bmod.get_params()[0].items()},
                    states=upd.get_states(dump_optimizer=True),
                    counts=dict(upd.optimizer._index_update_count),
                    data=batch.data[0].asnumpy(),
                    label=batch.label[0].asnumpy(), index=len(keys) - 1)
        forward(batch, is_train)

    def hooked_update():
        update()
        losses.append(_bucket_ce(bmod.get_outputs()[0]._data,
                               bmod._curr_module._exec_group.execs[0]
                               .arg_dict["softmax_label"]._data))
        if snap and "after" not in snap:
            snap["loss"] = losses[-1]
            snap["after"] = {k: v.asnumpy()
                             for k, v in bmod.get_params()[0].items()}

    def hooked_switch(key, *a, **kw):
        first = key not in bmod._buckets
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        switch(key, *a, **kw)
        torch.cuda.synchronize()
        switches.append((key, first, (time.perf_counter() - t0) * 1e3))

    bmod.forward, bmod.update = hooked_forward, hooked_update
    bmod.switch_bucket = hooked_switch

    # each batch's perplexity from the metric's running sums
    metric = mx.metric.Perplexity(ignore_label=0)
    ppls, last = [], [0.0, 0]

    def on_batch(param):
        m = param.eval_metric
        ppls.append(math.exp((m.sum_metric - last[0])
                             / (m.num_inst - last[1])))
        last[:] = [m.sum_metric, m.num_inst]

    # the main path: counts zeroed just before fit, read just after
    hr.lstm_fwd_launches = 0
    hr.lstm_bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bmod.fit(it, eval_metric=metric, optimizer="adam",
             optimizer_params={"learning_rate": BUCKET["lr"], "wd": 0.0},
             initializer=_bucket_initializer(mx), num_epoch=1,
             batch_end_callback=on_batch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = {"lstm_fwd": hr.lstm_fwd_launches,
                    "lstm_bwd": hr.lstm_bwd_launches}
    nb = len(keys)
    want = BUCKET["layers"]
    print("[bucketing] fit: %d batches (buckets %s), %.2f s; kernel "
          "launches %s (expected %d + %d a batch)"
          % (nb, keys, fit_s, fit_launches, want, want))
    check(nb >= 12 and set(keys) == set(BUCKET["buckets"]),
          "fit ran %d batches over buckets %s" % (nb, sorted(set(keys))))
    check(fit_launches == {"lstm_fwd": want * nb, "lstm_bwd": want * nb},
          "fit launched %s over %d batches, expected %d + %d a batch"
          % (fit_launches, nb, want, want))
    train_ppl = dict(metric.get_name_value())["perplexity"]

    # one set of parameter tensors
    base = bmod._buckets[it.default_bucket_key]._exec_group.execs[0]
    ptrs = {k: {n: m._exec_group.execs[0].arg_dict[n]._data.data_ptr()
                for n in m._param_names} for k, m in bmod._buckets.items()}
    shared = all(p == {n: base.arg_dict[n]._data.data_ptr() for n in p}
                 for p in ptrs.values())
    n_params = sum(int(np.prod(base.arg_dict[n].shape))
                   for n in bmod._curr_module._param_names)
    print("[bucketing] %d buckets bound, %d parameters (%.1f MB fp32); the "
          "parameter tensors' data_ptr()s the same in every bucket: %s"
          % (len(bmod._buckets), n_params, n_params * 4 / 1e6, shared))
    check(len(bmod._buckets) == len(BUCKET["buckets"]) and shared,
          "the buckets do not share one set of parameter tensors: %s" % ptrs)

    # the first T-10 batch against the CPU
    check("after" in snap, "fit trained no T-10 batch")
    closs, cupd, cpu_s = _bucket_cpu_step(mx, snap)
    rel_loss = abs(snap["loss"] - closs) / abs(closs)
    upd_err = {k: float(np.linalg.norm(snap["after"][k] - snap["before"][k]
                                       - cupd[k]) / np.linalg.norm(cupd[k]))
               for k in cupd}
    worst = max(upd_err, key=upd_err.get)
    print("[bucketing] the first T-10 batch (batch %d of the epoch) vs the "
          "CPU (plain versions, %.1f s): loss %.6f vs %.6f (rel %.3g, tol "
          "%g); Adam updates within %s of their norms (tol %g)"
          % (snap["index"], cpu_s, snap["loss"], closs, rel_loss, LOSS_RTOL,
             {k: "%.3g" % v for k, v in upd_err.items()},
             BUCKET_UPDATE_TOL))
    check(rel_loss <= LOSS_RTOL, "T-10 loss differs from the CPU's by %g"
          % rel_loss)
    check(upd_err[worst] <= BUCKET_UPDATE_TOL, "the update of %s differs "
          "from the CPU's by %g of its norm" % (worst, upd_err[worst]))
    del snap["before"], snap["after"], cupd

    # the objective (SoftmaxOutput's cross-entropy, pads included) falls
    # over the epoch; the per-token perplexity (pads left out) is checked
    # on the score below: most of the corpus's 33,277 transitions come
    # once or twice in an epoch, so a batch's rarely falls below uniform
    tail = float(np.mean(losses[-3:]))
    print("[bucketing] per-batch train perplexity %s; the epoch's %.2f; "
          "per-batch loss (pads included) %s"
          % (["%.1f" % p for p in ppls], train_ppl,
             ["%.4f" % v for v in losses]))
    check(all(math.isfinite(v) for v in ppls + losses)
          and tail < losses[0], "the loss did not fall: first batch %.4f, "
          "last three %.4f" % (losses[0], tail))

    # score: kernel 8 only, 2 a batch
    hr.lstm_fwd_launches = 0
    hr.lstm_bwd_launches = 0
    score_metric = mx.metric.Perplexity(ignore_label=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score_ppl = dict(bmod.score(it, score_metric))["perplexity"]
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    score_launches = {"lstm_fwd": hr.lstm_fwd_launches,
                      "lstm_bwd": hr.lstm_bwd_launches}
    n_score = len(it._plan)
    print("[bucketing] score: perplexity %.2f over %d batches in %.2f s, "
          "kernel launches %s" % (score_ppl, n_score, score_s,
                                  score_launches))
    check(score_launches == {"lstm_fwd": want * n_score, "lstm_bwd": 0},
          "score launched %s over %d batches" % (score_launches, n_score))
    check(math.isfinite(score_ppl) and score_ppl < ppls[0],
          "the trained model's perplexity %.2f is not below the first "
          "batch's %.2f" % (score_ppl, ppls[0]))

    # steps per bucket: forward, backward, update, timed on the host
    bmod.forward, bmod.update, bmod.switch_bucket = forward, update, switch

    def step(batch):
        bmod.forward(batch, is_train=True)
        bmod.backward()
        bmod.update()

    rates = {}
    for key in sorted(one_per_bucket):
        batch = one_per_bucket[key]
        times = []
        for i in range(1 + BUCKET["timed_steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        rates[key] = {"step_ms": ms, "tokens_per_s": B * key / (ms / 1e3),
                      "step_ms_min": min(times) * 1e3,
                      "step_ms_max": max(times) * 1e3}
        print("[bucketing] T=%d: step %.2f ms (median of %d after 1, min "
              "%.2f, max %.2f), %.1f train tokens/s on %s"
              % (key, ms, len(times), min(times) * 1e3, max(times) * 1e3,
                 rates[key]["tokens_per_s"], card))
    binds = [ms for _, first, ms in switches if first]
    later = [ms for _, first, ms in switches if not first]
    # a switch between two bound buckets, alone
    alt = []
    for i in range(20):
        key = BUCKET["buckets"][i % len(BUCKET["buckets"])]
        b = one_per_bucket[key]
        t0 = time.perf_counter()
        bmod.switch_bucket(key, b.provide_data, b.provide_label)
        alt.append((time.perf_counter() - t0) * 1e3)
    switch_ms = float(np.median(alt))
    print("[bucketing] bucket switch between bound buckets: %.4f ms median "
          "on the host (%d in fit and score: median %.4f ms); a bucket's "
          "first bind: %s ms" % (switch_ms, len(later), float(np.median(later))
                     if later else float("nan"),
                     ["%.1f" % v for v in binds]))

    # two profiled steps of a T-40 batch
    b40 = one_per_bucket[max(BUCKET["buckets"])]
    kernels, _ = profiled_kernels(lambda: step(b40), 2, "bucketing-profile")
    groups, counts = {}, {}
    for e in kernels:
        g = _bucket_group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 2e3
        counts[g] = counts.get(g, 0) + 1
    busy = sum(groups.values())
    check(busy > 0, "the profiler recorded no device time")
    traced = (counts.get("kernel 8 (lstm_fwd)", 0),
              counts.get("kernel 9 (lstm_bwd)", 0))
    check(traced == (2 * want, 2 * want), "the T-40 profile saw %d "
          "kernel-8 and %d kernel-9 launches in two steps" % traced)
    idle = max(0.0, 1 - busy / rates[40]["step_ms"])
    print("[bucketing-profile] a T-40 step: %.2f ms device busy in a %.2f "
          "ms step (%.1f%% idle), %d launches a step on %s"
          % (busy, rates[40]["step_ms"], 100 * idle, len(kernels) // 2, card))
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[bucketing-profile]   %-46s %8.3f ms/step (%.1f%%), %4d "
              "launches" % (g, ms, 100.0 * ms / busy, counts[g] // 2))
    launches = {k: fit_launches[k] + score_launches[k] for k in fit_launches}
    del bmod, it, one_per_bucket, b40
    torch.cuda.empty_cache()
    return launches, {
        "batches": nb, "bucket_order": keys, "fit_s": fit_s,
        "fit_launches": fit_launches, "score_launches": score_launches,
        "train_perplexity": train_ppl, "batch_perplexity": ppls,
        "batch_loss": losses,
        "score_perplexity": score_ppl, "parameters": n_params,
        "shared_parameter_tensors": shared, "per_bucket": rates,
        "switch_ms": switch_ms, "first_bind_ms": binds,
        "t10_vs_cpu": {"batch_index": snap["index"], "loss": snap["loss"],
                       "cpu_loss": closs, "loss_rel_err": rel_loss,
                       "update_rel_err": upd_err, "cpu_step_s": cpu_s},
        "profile_t40": {"busy_ms": busy, "idle_share": idle,
                        "device_ms_by_group": groups,
                        "launches_by_group": {g: c // 2 for g, c in
                                              counts.items()}},
        "config": dict(BUCKET, dtype="float32", optimizer="adam"),
        "phase_s": time.perf_counter() - t_phase}


# --------------------------------------------------------------------------
# phase 18: train_imagenet.py's data path (example/image-classification/
# train_imagenet.py:70-77): ImageRecordIter over a .rec of JPEGs that im2rec
# would write (short side 256, quality 95), feeding Module.fit
IMGREC = dict(images=1024, short=256, long=(256, 384), quality=95,
              classes=1000, batch=32, shape=(3, 224, 224), seed=18,
              mean=(123.68, 116.779, 103.939), std=(58.393, 57.12, 57.375),
              lr=0.1, momentum=0.9, wd=1e-4, psnr_min=40.0)
IMGREC_THREADS = ("imgrec-decode", "imgrec-producer")


def imgrec_photo(r, h, w, shapes=True):
    """A smooth random BGR field (uniform noise grids of 64, 16 and 4 px
    cells, upsampled bicubically, at falling amplitudes, and a little
    pixel noise) with a few filled rectangles and discs on it: it
    compresses like a photograph (about 45 KB at quality 95), where white
    noise would not.  ``shapes=False`` gives the 64 px octave alone."""
    import cv2
    img = np.full((h, w, 3), 128.0, np.float32)
    for cell, amp in ((64, 1.0), (16, 0.4), (4, 0.3)) if shapes \
            else ((64, 1.0),):
        grid = r.uniform(-127, 127, (h // cell + 2, w // cell + 2, 3))
        img += amp * cv2.resize(grid.astype(np.float32), (w, h),
                                interpolation=cv2.INTER_CUBIC)
    if shapes:
        img += r.normal(0, 4, img.shape).astype(np.float32)
        for _ in range(3):
            color = tuple(float(c) for c in r.uniform(0, 255, 3))
            x0, y0 = int(r.randint(0, w - 40)), int(r.randint(0, h - 40))
            if r.rand() < 0.5:
                cv2.rectangle(img, (x0, y0), (x0 + int(r.randint(20, 120)),
                                              y0 + int(r.randint(20, 120))),
                              color, -1)
            else:
                cv2.circle(img, (x0, y0), int(r.randint(10, 60)), color, -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_imgrec(prefix, n, seed):
    """``n`` images of short side 256 and long side 256-384 (each
    orientation), labels below 1,000, all from ``RandomState(seed)``,
    encoded in a thread pool and written in order with the port's
    ``MXIndexedRecordIO``/``pack_img``; returns (.rec, .idx, labels)."""
    import concurrent.futures
    from mxnet_tpu_torch import recordio
    r = np.random.RandomState(seed)
    labels = r.randint(0, IMGREC["classes"], n)
    sizes = []
    for _ in range(n):
        long_side = int(r.randint(IMGREC["long"][0], IMGREC["long"][1] + 1))
        sizes.append((IMGREC["short"], long_side) if r.rand() < 0.5
                     else (long_side, IMGREC["short"]))
    seeds = r.randint(0, 2 ** 31 - 1, n)

    def encode(k):
        img = imgrec_photo(np.random.RandomState(seeds[k]), *sizes[k])
        return recordio.pack_img(
            recordio.IRHeader(0, float(labels[k]), k, 0), img,
            quality=IMGREC["quality"])

    rec, idx = prefix + ".rec", prefix + ".idx"
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        for k, buf in enumerate(pool.map(encode, range(n))):
            w.write_idx(k, buf)
    w.close()
    return rec, idx, labels.astype(np.float32)


def _imgrec_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(IMGREC_THREADS)]


def _check_no_imgrec_threads(what):
    deadline = time.monotonic() + 10.0
    while _imgrec_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    check(not _imgrec_threads(), "%s left threads alive: %s"
          % (what, _imgrec_threads()))


def _imgrec_iter(rec, idx, ctx, **kw):
    import mxnet_tpu_torch as mx
    c, h, w = IMGREC["shape"]
    mean, std = IMGREC["mean"], IMGREC["std"]
    return mx.io.ImageRecordIter(
        rec, IMGREC["shape"], IMGREC["batch"], path_imgidx=idx, shuffle=True,
        rand_crop=True, rand_mirror=True, mean_r=mean[0], mean_g=mean[1],
        mean_b=mean[2], std_r=std[0], std_g=std[1], std_b=std[2], ctx=ctx,
        **kw)


def _drain_rate(rec, idx, threads):
    """One epoch of the iterator alone on gpu(0): images/s from the
    constructor to the last batch on the card, and the labels in order."""
    from mxnet_tpu_torch import gpu
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = _imgrec_iter(rec, idx, gpu(0), preprocess_threads=threads,
                      rng=np.random.RandomState(IMGREC["seed"]))
    try:
        labels = []
        for b in it:
            check(b.data[0]._data.is_cuda and b.label[0]._data.is_cuda,
                  "an ImageRecordIter batch is not on the card")
            labels.append(b.label[0]._data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        it.close()
    _check_no_imgrec_threads("close() after %d threads" % threads)
    labels = torch.cat(labels).cpu().numpy()
    return len(labels) / dt, labels


def _imgrec_fit(rec, idx, threads, on_card=True):
    """One ``Module.fit`` epoch of resnet50_v1 from ``ImageRecordIter`` at
    ``threads`` decode threads (``Xavier(gaussian, 2)`` after
    ``random.seed(7)``, SGD lr 0.1 momentum 0.9 wd 1e-4, accuracy): the
    iterator timed in ``next()``, each batch's copy to the card by CUDA
    events around the producer's ``_place``, each batch's mean
    cross-entropy; checks the batch count and finite losses and that
    ``close()`` ends every thread.  ``on_card=False`` leaves the batches
    on ``cpu()``, so that the Module copies them in its own thread."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cpu, gpu
    from mxnet_tpu_torch.gluon.model_zoo import vision

    class CopyTimed(mx.io.ImageRecordIter):
        def __init__(self, *a, **kw):
            self.copies = []
            super().__init__(*a, **kw)

        def _place(self, chw, label):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            placed = super()._place(chw, label)
            e.record()
            self.copies.append((s, e))
            return placed

    class Timed(mx.io.DataIter):
        def __init__(self, inner):
            super().__init__(inner.batch_size)
            self.inner, self.waits, self.starts = inner, [], []

        @property
        def provide_data(self):
            return self.inner.provide_data

        @property
        def provide_label(self):
            return self.inner.provide_label

        def reset(self):
            self.inner.reset()

        def __next__(self):
            t0 = time.perf_counter()
            self.starts.append(t0)
            b = next(self.inner)
            self.waits.append(time.perf_counter() - t0)
            return b

        next = __next__

    class AccWithLoss(mx.metric.Accuracy):
        """Accuracy, which also keeps each batch's mean cross-entropy."""

        def __init__(self):
            super().__init__()
            self.losses = []

        def update(self, labels, preds):
            super().update(labels, preds)
            p = preds[0]._data
            y = labels[0]._data.to(p.device).long()
            self.losses.append(float(-torch.log(p.gather(
                1, y[:, None]).clamp_min(1e-30)).mean()))

    mean, std = IMGREC["mean"], IMGREC["std"]
    inner = CopyTimed(rec, IMGREC["shape"], IMGREC["batch"],
                      path_imgidx=idx, shuffle=True, rand_crop=True,
                      rand_mirror=True, mean_r=mean[0], mean_g=mean[1],
                      mean_b=mean[2], std_r=std[0], std_g=std[1],
                      std_b=std[2], preprocess_threads=threads,
                      ctx=gpu(0) if on_card else cpu(),
                      rng=np.random.RandomState(IMGREC["seed"] + 1))
    it = Timed(inner)
    with mx.name.NameManager():
        sym = mx.sym.SoftmaxOutput(
            vision.resnet50_v1(classes=IMGREC["classes"])(
                mx.sym.var("data")),
            mx.sym.var("softmax_label"), name="softmax")
    mod = mx.mod.Module(sym, context=[gpu(0)])
    metric = AccWithLoss()
    mx.random.seed(R50MOD["init_seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        mod.fit(it, num_epoch=1, eval_metric=metric,
                initializer=mx.init.Xavier(rnd_type="gaussian",
                                           magnitude=2.0),
                optimizer="sgd", optimizer_params={
                    "learning_rate": IMGREC["lr"],
                    "momentum": IMGREC["momentum"], "wd": IMGREC["wd"]})
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    finally:
        inner.close()
    _check_no_imgrec_threads("close() after fit")
    batches = IMGREC["images"] // IMGREC["batch"]
    check(len(it.waits) == batches, "fit ran %d batches, expected %d"
          % (len(it.waits), batches))   # the last next() raised
    check(len(metric.losses) == batches
          and bool(np.isfinite(metric.losses).all()),
          "fit's losses %s" % metric.losses)
    copies = [s.elapsed_time(e) for s, e in inner.copies] if on_card \
        else [float("nan")]
    steady_s = t_end - it.starts[2]     # batches 3-32, to the card's end
    return {"fit_images_per_s": (batches - 2) * IMGREC["batch"] / steady_s,
            "fit_s": t_end - t0, "step_ms": steady_s / (batches - 2) * 1e3,
            "fit_arm": "fused" if mod._fused_step is not None
            and mod._fused_step.eligible() else "eager",
            "wait_s": sum(it.waits), "wait_share": sum(it.waits)
            / (t_end - t0), "wait_share_steady": sum(it.waits[2:])
            / steady_s, "copy_ms_median": float(np.median(copies)),
            "copy_ms_max": float(np.max(copies)), "copies": len(copies),
            "losses": [metric.losses[0], metric.losses[-1]],
            "accuracy": float(metric.get()[1]), "threads": threads}


def _imgrec_stage_costs(rec, idx, n=64):
    """Host ms of each pipeline stage on one thread with the card idle:
    reading a record, decoding it (cv2), augmenting it (crop, mirror,
    normalise), a batch's HWC -> CHW transposition, its placement on the
    card (``nd.array``, pageable)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cpu, gpu, recordio
    it = _imgrec_iter(rec, idx, cpu(), preprocess_threads=1,
                      rng=np.random.RandomState(0))
    it.close()
    r = recordio.MXIndexedRecordIO(idx, rec, "r")
    try:
        n = min(n, len(r.keys))
        t0 = time.perf_counter()
        raws = [r.read_idx(k) for k in range(n)]
        read_ms = (time.perf_counter() - t0) / n * 1e3
    finally:
        r.close()
    t0 = time.perf_counter()
    imgs = [recordio.unpack_img(raw, iscolor=1)[1] for raw in raws]
    decode_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    outs = [it._augment(img) for img in imgs]
    augment_ms = (time.perf_counter() - t0) / n * 1e3
    # the augmentation's steps apart: the crop and mirror views made
    # contiguous, then cv2's cvtColor, multiply and add, and numpy's arm
    import cv2
    c, h, w = IMGREC["shape"]
    a = it.scale / it.std
    b = -it.mean * a
    mul = tuple(float(v) for v in a) + (0.0,)
    add = tuple(float(v) for v in b) + (0.0,)
    steps = dict.fromkeys(("crop_ms", "cvtcolor_ms", "multiply_ms",
                           "add_ms", "numpy_arm_ms"), 0.0)
    for img in imgs:
        t = [time.perf_counter()]
        crop = np.ascontiguousarray(img[:h, :w][:, ::-1])
        t.append(time.perf_counter())
        rgb = cv2.cvtColor(crop, cv2.COLOR_BGR2RGB)
        t.append(time.perf_counter())
        prod = cv2.multiply(rgb, mul, dtype=cv2.CV_32F)
        t.append(time.perf_counter())
        cv2.add(prod, add)
        t.append(time.perf_counter())
        crop[..., ::-1].astype(np.float32) * a + b
        t.append(time.perf_counter())
        for key, t0, t1 in zip(steps, t, t[1:]):
            steps[key] += (t1 - t0) / n * 1e3
    B = IMGREC["batch"]
    hwc = np.stack(outs[:B])
    chw = np.empty((B,) + IMGREC["shape"], np.float32)
    t0 = time.perf_counter()
    for _ in range(5):
        np.copyto(chw, hwc.transpose(0, 3, 1, 2))
    transpose_ms = (time.perf_counter() - t0) / 5 * 1e3
    mx.nd.array(chw, gpu(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        mx.nd.array(chw, gpu(0))
    torch.cuda.synchronize()
    place_ms = (time.perf_counter() - t0) / 5 * 1e3
    return {"read_ms_image": read_ms, "decode_ms_image": decode_ms,
            "augment_ms_image": augment_ms, "augment_steps_ms": steps,
            "transpose_ms_batch": transpose_ms, "place_ms_batch": place_ms,
            "one_thread_images_per_s": 1e3 / (
                read_ms + decode_ms + augment_ms
                + (transpose_ms + place_ms) / B)}


def phase_imgrec(card, module_ips):
    """Phase 18: ResNet-50 v1 trained through ``Module.fit`` from
    ``ImageRecordIter`` over a synthetic ``.rec`` that the phase writes
    (1,024 JPEGs, short side 256, quality 95, labels below 1,000): the
    iterator alone at the default and at the host's thread count; the
    first batch at one thread on gpu(0) bit for bit the cpu()'s; the
    labels those written, in the shuffled order; ``fit`` for one epoch
    (32 batches, SGD lr 0.1 momentum 0.9 wd 1e-4, acc) with the counters
    zeroed just before and read just after; every batch's loss finite; a
    round trip above 40 dB PSNR; no thread left after ``close()``.  Then
    the same fit at one decode thread and with OpenCV's own threads off,
    each stage's host ms on one thread, and the copy alone."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cpu, gpu, recordio
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    t_phase = time.perf_counter()
    os.environ.pop("MXNET_CKPT_DIR", None)
    try:
        import cv2  # noqa: F401
        decoder = "cv2 %s" % cv2.__version__
    except ImportError:
        import PIL
        decoder = "PIL %s" % PIL.__version__
    cores = len(os.sched_getaffinity(0))
    default_threads = int(os.environ.get("MXNET_CPU_WORKER_NTHREADS", "4"))
    out = {"decoder": decoder, "cores": cores,
           "default_threads": default_threads}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_imgrec_") as tmp:
        t0 = time.perf_counter()
        rec, idx, labels = write_imgrec(os.path.join(tmp, "train"),
                                        IMGREC["images"], IMGREC["seed"])
        out["write_s"] = time.perf_counter() - t0
        out["rec_bytes"] = os.path.getsize(rec)
        print("[imgrec] wrote %d JPEGs (short side %d, long %d-%d, quality "
              "%d) in %.2f s: %.1f MB, %.1f KB an image; decoder %s; %d "
              "cores, default preprocess_threads %d"
              % (IMGREC["images"], IMGREC["short"], *IMGREC["long"],
                 IMGREC["quality"], out["write_s"], out["rec_bytes"] / 1e6,
                 out["rec_bytes"] / IMGREC["images"] / 1e3, decoder, cores,
                 default_threads))

        # the round trip of a known smooth image
        img = imgrec_photo(np.random.RandomState(IMGREC["seed"]), 256, 320,
                           shapes=False)
        _, back = recordio.unpack_img(recordio.pack_img(
            (0, 0.0, 0, 0), img, quality=IMGREC["quality"]), iscolor=1)
        mse = float(np.mean((back.astype(np.float64) - img) ** 2))
        out["psnr_db"] = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
        check(out["psnr_db"] > IMGREC["psnr_min"], "JPEG round trip at %.2f "
              "dB PSNR" % out["psnr_db"])

        # the first batch at one thread: the card's bit for bit the CPU's
        first = {}
        for name, ctx in (("gpu", gpu(0)), ("cpu", cpu())):
            it = _imgrec_iter(rec, idx, ctx, preprocess_threads=1,
                              rng=np.random.RandomState(IMGREC["seed"]))
            try:
                b = next(it)
                first[name] = (b.data[0].asnumpy(), b.label[0].asnumpy(),
                               b.data[0]._data.device.type)
            finally:
                it.close()
        check(first["gpu"][2] == "cuda" and first["cpu"][2] == "cpu",
              "first batches on %s and %s" % (first["gpu"][2],
                                              first["cpu"][2]))
        check(np.array_equal(first["gpu"][0], first["cpu"][0])
              and np.array_equal(first["gpu"][1], first["cpu"][1]),
              "the first batch on gpu(0) differs from the cpu() one by %g"
              % float(np.abs(first["gpu"][0] - first["cpu"][0]).max()))
        _check_no_imgrec_threads("close()")

        # the iterator alone, at the default and at the host's threads
        order = list(range(IMGREC["images"]))
        np.random.RandomState(IMGREC["seed"]).shuffle(order)
        want = labels[order]
        rates = {}
        for threads in sorted({default_threads, cores}):
            rates[threads], got = _drain_rate(rec, idx, threads)
            check(np.array_equal(got, want), "labels at %d threads differ "
                  "from those written, in the shuffled order" % threads)
        out["iter_images_per_s"] = rates
        print("[imgrec] iterator alone (decode, crop 224, mirror, normalise, "
              "batch 32 to gpu(0)), one epoch: %s images/s by decode "
              "threads; labels equal those written in the shuffled order; "
              "the first batch at one thread on gpu(0) equals the cpu() "
              "one bit for bit; round trip %.2f dB PSNR"
              % ({k: round(v, 1) for k, v in rates.items()},
                 out["psnr_db"]))

        # train_imagenet.py's fit at the default decode threads, counted;
        # then, to see what slows the step, at one decode thread and with
        # OpenCV's own worker threads off (one a call)
        _zero_conv_counts(hc)
        fit = _imgrec_fit(rec, idx, default_threads)
        launches = _conv_counts(hc)
        batches = IMGREC["images"] // IMGREC["batch"]
        want_counts = {"implicit_gemm_conv": 32,
                       "implicit_gemm_conv reduction":
                           conv_reductions_per_step(),
                       "taps_wgrad": 16,
                       "taps_wgrad reduction": wgrad_reductions_per_step()}
        check(all(launches[k] == want_counts[k] * batches
                  for k in want_counts)
              and launches["taps_conv_bf16"] == 0
              and launches["taps_wgrad_bf16"] == 0,
              "fit's launches %s over %d batches, expected %s a batch"
              % (launches, batches, want_counts))
        out.update(fit, module_images_per_s=module_ips, launches=launches)
        print("[imgrec] Module.fit of resnet50_v1 (%s arm), 1 epoch of %d "
              "batches of %d from ImageRecordIter (%d decode threads): %.1f "
              "images/s over batches 3-%d (%.2f ms a batch), beside phase "
              "13's Module %.1f images/s from in-memory batches; fit %.2f s, "
              "%.2f s of it waiting in next() (%.1f%%; %.1f%% over batches "
              "3-%d); the batch's copy to the card %.4f ms median of %d "
              "(max %.4f; CUDA events around nd.array in the producer); "
              "loss %.4f -> %.4f, all finite; launches over the epoch %s "
              "(%d batches x %s) on %s"
              % (fit["fit_arm"], batches, IMGREC["batch"], default_threads,
                 fit["fit_images_per_s"], batches, fit["step_ms"],
                 module_ips, fit["fit_s"], fit["wait_s"],
                 100 * fit["wait_share"], 100 * fit["wait_share_steady"],
                 batches, fit["copy_ms_median"], fit["copies"],
                 fit["copy_ms_max"], *fit["losses"], launches, batches,
                 want_counts, card))
        import cv2
        cv_threads = cv2.getNumThreads()
        out["opencv_threads"] = cv_threads
        variants = out["variants"] = {}
        for name, threads, on_card, cv_set in (
                ("one decode thread", 1, True, cv_threads),
                ("batches left on cpu()", default_threads, False, cv_threads),
                ("OpenCV's own threads off", default_threads, True, 1)):
            cv2.setNumThreads(cv_set)
            try:
                v = variants[name] = _imgrec_fit(rec, idx, threads, on_card)
            finally:
                cv2.setNumThreads(cv_threads)
            print("[imgrec] the same fit, %s (%d decode threads, OpenCV "
                  "threads %d): %.1f images/s over batches 3-%d (%.2f ms a "
                  "batch), waiting in next() %.1f%% (%.1f%% over batches "
                  "3-%d), copy %.4f ms median"
                  % (name, threads, cv_set, v["fit_images_per_s"], batches,
                     v["step_ms"], 100 * v["wait_share"],
                     100 * v["wait_share_steady"], batches,
                     v["copy_ms_median"]))
        out["stages"] = _imgrec_stage_costs(rec, idx)
        print("[imgrec] stages on one thread, the card idle: %s"
              % {k: v if isinstance(v, dict) else round(v, 4)
                 for k, v in out["stages"].items()})

        # the copy alone, on an idle card: the batch's pageable copy as
        # nd.array makes it, and a pinned one (the yardstick for a pinned
        # staging buffer; the port has no cpu_pinned() context yet)
        host = np.random.RandomState(0).standard_normal(
            (IMGREC["batch"],) + IMGREC["shape"]).astype(np.float32)
        pinned = torch.from_numpy(host).pin_memory()
        out["copy_ms_idle"] = time_ms(lambda: mx.nd.array(host, gpu(0)))
        out["copy_ms_pinned"] = time_ms(
            lambda: pinned.to("cuda", non_blocking=True))
        print("[imgrec] a batch's copy (%.1f MB) on an idle card: %.4f ms "
              "pageable through nd.array, %.4f ms from pinned memory; "
              "phase %.1f s" % (host.nbytes / 1e6, out["copy_ms_idle"],
                                out["copy_ms_pinned"],
                                time.perf_counter() - t_phase))
    out["phase_s"] = time.perf_counter() - t_phase
    return launches, out


# --------------------------------------------------------------------------
EAGER_TIMED_STEPS = 20
EAGER_NOHYB_STEPS = 2
EAGER_NOHYB_TIMED_STEPS = 10
EAGER_NOHYB_TOL = 1e-5   # |loss not hybridized - hybridized| / |hybridized|
EAGER_LM_LOSS_RTOL = 1e-5
EAGER_LM_UPDATE_TOL = 1e-3
G2C_TOL = 1e-6           # group2ctx executor vs the ungrouped one, absolute


class _EagerStep:
    """One imperative training step of a Gluon net: the forward and the
    loss under ``autograd.record``, ``backward``, ``Trainer.step(batch)``.
    ``step(x, y)`` returns the per-example loss, so the profiling helpers
    call it as they call a ``FusedTrainer``."""

    def __init__(self, net, batch, learning_rate, momentum=0.0,
                 optimizer="sgd", wd=0.0):
        from mxnet_tpu_torch import gluon
        opt = {"learning_rate": learning_rate}
        if momentum:
            opt["momentum"] = momentum
        if wd:
            opt["wd"] = wd
        self.net, self.batch = net, batch
        self.trainer = gluon.Trainer(net.collect_params(), optimizer, opt)
        self.loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def step(self, x, y):
        from mxnet_tpu_torch import autograd
        with autograd.record():
            loss = self.loss_fn(self.net(x), y)
        loss.backward()
        self.trainer.step(self.batch)
        return loss

    def host_split(self, x, y, n=5):
        """Median host ms of each part of a step (the forward and loss
        under ``record``, ``backward``, ``Trainer.step``: the time to queue
        its work, no sync between them) and of the wait for the card at
        its end."""
        from mxnet_tpu_torch import autograd
        parts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            with autograd.record():
                loss = self.loss_fn(self.net(x), y)
            t.append(time.perf_counter())
            loss.backward()
            t.append(time.perf_counter())
            self.trainer.step(self.batch)
            t.append(time.perf_counter())
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            parts.append(np.diff(t) * 1e3)
        med = np.median(np.array(parts), axis=0)
        return dict(zip(("forward_ms", "backward_ms", "trainer_step_ms",
                         "wait_ms"), (float(v) for v in med)))


def _turns(fused, eager, n=10):
    """Median host ms a step of ``fused`` and of ``eager``, timed in turns
    on one card (fused, eager, eager, fused), ``n`` steps a turn after the
    warm-up: the comparison that the host's drift between phases does not
    bias."""
    out = {"fused": [], "eager": []}
    for name, fn in (("fused", fused), ("eager", eager), ("eager", eager),
                     ("fused", fused)):
        out[name].append(float(np.median(timed_steps(fn, timed=n))) * 1e3)
    return out


def _median_ms_gc_off(step, n=10):
    """Median host ms of ``n`` timed calls of ``step`` with Python's
    garbage collector off (collected once before)."""
    gc.collect()
    gc.disable()
    try:
        times = timed_steps(step, timed=n)
    finally:
        gc.enable()
    return float(np.median(times)) * 1e3


def _fused_host_ms(ft, x, y, n=5):
    """Median host ms to queue a ``FusedTrainer`` step, and the wait for
    the card after it."""
    parts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ft.step(x, y)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        parts.append((t1 - t0, time.perf_counter() - t1))
    med = np.median(np.array(parts), axis=0) * 1e3
    return {"queue_ms": float(med[0]), "wait_ms": float(med[1])}


def _mean_loss(loss) -> float:
    return float(loss.asnumpy().mean())


def _two_group_mlp():
    from mxnet_tpu_torch import AttrScope, sym
    data = sym.var("data")
    with AttrScope(ctx_group="dev1"):
        h = sym.FullyConnected(data, num_hidden=16, name="fc1")
        h = sym.Activation(h, act_type="relu")
    with AttrScope(ctx_group="dev2"):
        h = sym.FullyConnected(h, num_hidden=8, name="fc2")
        return sym.SoftmaxOutput(h, name="softmax")


def _eager_group2ctx():
    """The two-group MLP bound on cpu(0) with ``dev2`` on the card, against
    the ungrouped gpu(0) executor: forward and backward."""
    from mxnet_tpu_torch import cpu, gpu
    net = _two_group_mlp()
    ex = net.simple_bind(ctx=cpu(0), group2ctx={"dev1": cpu(0),
                                                "dev2": gpu(0)},
                         data=(4, 12))
    ex1 = net.simple_bind(ctx=gpu(0), data=(4, 12))
    rng = np.random.default_rng(SEED)
    for n, a in ex.arg_dict.items():
        v = rng.uniform(size=a.shape) if n == "data" else \
            rng.integers(0, 8, a.shape) if n == "softmax_label" else \
            rng.uniform(-0.1, 0.1, a.shape)
        ex.arg_dict[n][:] = v
        ex1.arg_dict[n][:] = v
    got = []
    for e in (ex, ex1):
        out = e.forward(is_train=True)[0]
        e.backward()
        got.append((out, {n: g.asnumpy() for n, g in e.grad_dict.items()
                          if n not in ("data", "softmax_label")}))
    (out, grads), (out1, grads1) = got
    err_out = float(np.abs(out.asnumpy() - out1.asnumpy()).max())
    err_grad = max(float(np.abs(grads[n] - grads1[n]).max())
                   for n in grads1)
    placed = {n.name: str(ctx) for n in ex._plan(True).topo
              if not n.is_var
              for ctx in [ex._plan(True).placed[id(n)]]}
    print("[eager] group2ctx: dev1 on cpu(0), dev2 on gpu(0): output on %s "
          "(%s), placement %s; vs the ungrouped gpu(0) executor: output "
          "%.3g, gradients %.3g (tol %g)" % (out.context,
                                             out._data.device, placed,
                                             err_out, err_grad, G2C_TOL))
    check(out.context == gpu(0) and out._data.device.type == "cuda",
          "the dev2 group's output is on %s" % out.context)
    check(sorted(grads) == ["fc1_bias", "fc1_weight", "fc2_bias",
                            "fc2_weight"], "gradients %s" % sorted(grads))
    check(max(err_out, err_grad) <= G2C_TOL, "group2ctx differs from the "
          "ungrouped executor by %g" % max(err_out, err_grad))
    return {"output_context": str(out.context), "output_err": err_out,
            "grad_err": err_grad, "placement": placed}


def _fp32_conv_counts(hc):
    c = _conv_counts(hc)
    return {k: c[k] for k in ("implicit_gemm_conv",
                              "implicit_gemm_conv reduction", "taps_wgrad",
                              "taps_wgrad reduction")}


def _update_norm_err(got, want):
    return max(float(np.linalg.norm(got[k] - want[k])
                     / np.linalg.norm(want[k])) for k in want)


def _eager_resnet(card, fused_ips):
    """Phase 5's ResNet-50 v1 through ``Trainer``: hybridized (first step vs
    FusedTrainer's, launches, 20 timed steps, profile), then not
    hybridized (two steps, launches, losses vs the hybridized arm's)."""
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.fused import FusedTrainer
    from mxnet_tpu_torch.ops import hopper_conv as hc
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    want = {"implicit_gemm_conv": 32,
            "implicit_gemm_conv reduction": conv_reductions_per_step(),
            "taps_wgrad": 16,
            "taps_wgrad reduction": wgrad_reductions_per_step()}

    # FusedTrainer's first step from the state every arm starts from
    fnet, x, y = gluon_resnet50(gpu(0), BATCH)
    fnet(x).wait_to_read()
    convs = sorted(_conv3x3_weights(fnet))
    w0 = {k: fnet.collect_params()[k].data().asnumpy() for k in convs}
    ft = FusedTrainer(fnet, "softmax_cross_entropy", "sgd", dict(opt))
    fused_loss = float(ft.step(x, y).asnumpy())
    ft.sync_params()
    fused_upd = {k: fnet.collect_params()[k].data().asnumpy() - w0[k]
                 for k in convs}
    fused_host = _fused_host_ms(ft, x, y)
    fx, fy = x, y

    # eager, hybridized: the first step, then the timed ones
    net, x, y = gluon_resnet50(gpu(0), BATCH)
    net(x).wait_to_read()
    check(all(np.array_equal(net.collect_params()[k].data().asnumpy(),
                             w0[k]) for k in convs),
          "the eager arm starts from other weights than FusedTrainer's")
    eager = _EagerStep(net, BATCH, **opt)
    _zero_conv_counts(hc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [_mean_loss(eager.step(x, y))]
    first_s = time.perf_counter() - t0
    upd = {k: net.collect_params()[k].data().asnumpy() - w0[k]
           for k in convs}
    rel_loss = abs(losses[0] - fused_loss) / abs(fused_loss)
    upd_err = _update_norm_err(upd, fused_upd)
    print("[eager] resnet50_v1 hybridized, first step vs FusedTrainer's on "
          "the card from the same state: loss %.6f vs %.6f (rel %.3g, tol "
          "%g); 16 3x3 updates within %.3g of their norm (tol %g)"
          % (losses[0], fused_loss, rel_loss, LOSS_RTOL, upd_err,
             UPDATE_TOL))
    check(rel_loss <= LOSS_RTOL, "the eager first loss differs from "
          "FusedTrainer's by %g" % rel_loss)
    check(upd_err <= UPDATE_TOL, "an eager 3x3 update differs from "
          "FusedTrainer's by %g of its norm" % upd_err)
    times = timed_steps(lambda: eager.step(x, y),
                        lambda loss: losses.append(_mean_loss(loss)),
                        timed=EAGER_TIMED_STEPS)
    steps = len(losses)
    launches = _fp32_conv_counts(hc)
    print("[eager] hybridized: %d steps ran %s launches (per step %s; "
          "FusedTrainer's a step %s)" % (steps, launches,
                                        {k: v / steps for k, v in
                                         launches.items()}, want))
    check(all(launches[k] == want[k] * steps for k in want),
          "eager launch counts %s over %d steps, expected %s a step"
          % (launches, steps, want))
    check(all(math.isfinite(v) for v in losses), "non-finite eager loss: %s"
          % losses)
    step_ms = float(np.median(times)) * 1e3
    ips = BATCH / (step_ms / 1e3)
    print("[eager] hybridized, batch %d: first step %.1f ms, %d timed steps "
          "median %.2f ms (min %.2f, max %.2f): %.1f images/s against "
          "FusedTrainer's %.1f (phase 5) on %s"
          % (BATCH, first_s * 1e3, EAGER_TIMED_STEPS, step_ms,
             min(times) * 1e3, max(times) * 1e3, ips, fused_ips, card))
    profile = phase_training_profile(card, lambda: eager.step(x, y), step_ms,
                                     tag="eager-profile")
    host = eager.host_split(x, y)
    host["step_ms_gc_off"] = _median_ms_gc_off(lambda: eager.step(x, y))
    print("[eager] hybridized, host ms to queue a step: forward and loss "
          "%.2f, backward %.2f, Trainer.step %.2f, then %.2f waiting for "
          "the card; FusedTrainer's step: %.2f to queue, %.2f waiting; the "
          "median step with the garbage collector off %.2f ms"
          % (host["forward_ms"], host["backward_ms"],
             host["trainer_step_ms"], host["wait_ms"],
             fused_host["queue_ms"], fused_host["wait_ms"],
             host["step_ms_gc_off"]))
    turns = _turns(lambda: ft.step(fx, fy), lambda: eager.step(x, y))
    print("[eager] hybridized vs FusedTrainer in turns (fused, eager, eager, "
          "fused; 10 steps each): median step ms fused %s, eager %s on %s"
          % (["%.2f" % v for v in turns["fused"]],
             ["%.2f" % v for v in turns["eager"]], card))
    hyb_losses = losses[:EAGER_NOHYB_STEPS]
    del eager, net, x, y, ft, fnet, fx, fy

    # eager, not hybridized: every op through nd, recorded
    nnet, x, y = gluon_resnet50(gpu(0), BATCH, hybridize=False)
    nnet(x).wait_to_read()
    neager = _EagerStep(nnet, BATCH, **opt)
    _zero_conv_counts(hc)
    nlosses = []
    ntimes = []
    for _ in range(EAGER_NOHYB_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = neager.step(x, y)
        torch.cuda.synchronize()
        ntimes.append(time.perf_counter() - t0)
        nlosses.append(_mean_loss(loss))
    ntimed = timed_steps(lambda: neager.step(x, y),
                         timed=EAGER_NOHYB_TIMED_STEPS)
    nsteps = EAGER_NOHYB_STEPS + WARMUP_STEPS + EAGER_NOHYB_TIMED_STEPS
    nlaunches = _fp32_conv_counts(hc)
    check(nnet._cached_op is None, "the not-hybridized net built a CachedOp")
    nstep_ms = float(np.median(ntimed)) * 1e3
    nprofile = phase_training_profile(card, lambda: neager.step(x, y),
                                      nstep_ms, tag="eager-nohyb-profile")
    nhost = neager.host_split(x, y)
    print("[eager] not hybridized, %d timed steps median %.2f ms (min %.2f, "
          "max %.2f): %.1f images/s; host ms to queue a step: forward and "
          "loss %.2f, backward %.2f, Trainer.step %.2f, then %.2f waiting"
          % (EAGER_NOHYB_TIMED_STEPS, nstep_ms, min(ntimed) * 1e3,
             max(ntimed) * 1e3, BATCH / (nstep_ms / 1e3),
             nhost["forward_ms"], nhost["backward_ms"],
             nhost["trainer_step_ms"], nhost["wait_ms"]))
    nerr = max(abs(a - b) / abs(b) for a, b in zip(nlosses, hyb_losses))
    print("[eager] not hybridized: %d steps ran %s launches (expected %s a "
          "step); the first %d losses %s vs the hybridized arm's %s (rel "
          "%.3g, tol %g), those steps %.1f ms and %.1f ms"
          % (nsteps, nlaunches, want, EAGER_NOHYB_STEPS,
             ["%.6f" % v for v in nlosses], ["%.6f" % v for v in hyb_losses],
             nerr, EAGER_NOHYB_TOL, ntimes[0] * 1e3, ntimes[-1] * 1e3))
    check(all(nlaunches[k] == want[k] * nsteps for k in want),
          "not-hybridized launch counts %s over %d steps, expected %s a "
          "step" % (nlaunches, nsteps, want))
    check(nerr <= EAGER_NOHYB_TOL, "the not-hybridized losses differ from "
          "the hybridized arm's by %g" % nerr)
    del neager, nnet, x, y
    return launches, nlaunches, {
        "images_per_s": ips, "fused_images_per_s": fused_ips,
        "step_ms": step_ms, "step_ms_min": min(times) * 1e3,
        "step_ms_max": max(times) * 1e3, "first_step_ms": first_s * 1e3,
        "steps": steps, "losses": losses,
        "vs_fused": {"loss_rel_err": rel_loss, "update_rel_err_max": upd_err},
        "not_hybridized": {"losses": nlosses, "loss_rel_err": nerr,
                           "first_step_ms": [t * 1e3 for t in ntimes],
                           "step_ms": nstep_ms,
                           "images_per_s": BATCH / (nstep_ms / 1e3),
                           "launches": nlaunches,
                           "launches_per_step": {k: v / nsteps for k, v in
                                                 nlaunches.items()},
                           "host": nhost, "profile": nprofile},
        "host": host, "fused_host": fused_host, "turns_ms": turns,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "profile": profile}


def _eager_lm(card, fused_tps):
    """bench.py's LM through ``Trainer``, hybridized: its first step vs
    FusedTrainer's with the same dropout generator, launches, 20 timed
    steps, profile."""
    from mxnet_tpu_torch import gpu, random
    from mxnet_tpu_torch.ops import hopper_rnn as hr
    seed = SEED + 11
    fnet, x, y = gluon_lm(gpu(0), LM["dropout"])
    w0 = {k: p.data().asnumpy() for k, p in fnet.collect_params().items()}
    random.seed(seed)
    ft = _lm_trainer(fnet)
    fused_loss = float(ft.step(x, y).asnumpy())
    ft.sync_params()
    fused_upd = {k: p.data().asnumpy() - w0[k]
                 for k, p in fnet.collect_params().items()}
    fused_host = _fused_host_ms(ft, x, y)
    fx, fy = x, y
    net, x, y = gluon_lm(gpu(0), LM["dropout"])
    check(all(np.array_equal(p.data().asnumpy(), w0[k])
              for k, p in net.collect_params().items()),
          "the eager LM starts from other weights than FusedTrainer's")
    # the loss's first axis is time: Trainer.step(bptt) averages as the
    # FusedTrainer's mean over every token does
    eager = _EagerStep(net, LM["bptt"], LM["lr"])
    hr.lstm_fwd_launches = hr.lstm_bwd_launches = 0
    random.seed(seed)
    losses = [_mean_loss(eager.step(x, y))]
    upd = {k: p.data().asnumpy() - w0[k]
           for k, p in net.collect_params().items()}
    rel_loss = abs(losses[0] - fused_loss) / abs(fused_loss)
    upd_err = _update_norm_err(upd, fused_upd)
    print("[eager] LM, first step vs FusedTrainer's from the same state and "
          "dropout generator (random.seed(%d) before each): loss %.7f vs "
          "%.7f (rel %.3g, tol %g); every update within %.3g of its norm "
          "(tol %g)" % (seed, losses[0], fused_loss, rel_loss,
                        EAGER_LM_LOSS_RTOL, upd_err, EAGER_LM_UPDATE_TOL))
    check(rel_loss <= EAGER_LM_LOSS_RTOL, "the eager LM's first loss "
          "differs from FusedTrainer's by %g" % rel_loss)
    check(upd_err <= EAGER_LM_UPDATE_TOL, "an eager LM update differs "
          "from FusedTrainer's by %g of its norm" % upd_err)
    times = timed_steps(lambda: eager.step(x, y),
                        lambda loss: losses.append(_mean_loss(loss)),
                        timed=EAGER_TIMED_STEPS)
    steps = len(losses)
    launches = {"lstm_fwd": hr.lstm_fwd_launches,
                "lstm_bwd": hr.lstm_bwd_launches}
    print("[eager] LM: %d steps ran %s launches (expected %d each a step)"
          % (steps, launches, LM["layers"]))
    check(all(v == LM["layers"] * steps for v in launches.values()),
          "eager LM launch counts %s over %d steps" % (launches, steps))
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          "the eager LM's loss is not finite and falling: %s" % losses)
    step_ms = float(np.median(times)) * 1e3
    tps = LM["bptt"] * LM["batch"] / (step_ms / 1e3)
    print("[eager] LM: %d timed steps median %.2f ms (min %.2f, max %.2f): "
          "%.1f train tokens/s against FusedTrainer's %.1f (phase 7) on %s"
          % (EAGER_TIMED_STEPS, step_ms, min(times) * 1e3, max(times) * 1e3,
             tps, fused_tps, card))
    profile = phase_lm_profile(card, (eager, x, y), step_ms)
    host = eager.host_split(x, y)
    print("[eager] LM, host ms to queue a step: forward and loss %.2f, "
          "backward %.2f, Trainer.step %.2f, then %.2f waiting; "
          "FusedTrainer's: %.2f to queue, %.2f waiting"
          % (host["forward_ms"], host["backward_ms"],
             host["trainer_step_ms"], host["wait_ms"],
             fused_host["queue_ms"], fused_host["wait_ms"]))
    turns = _turns(lambda: ft.step(fx, fy), lambda: eager.step(x, y))
    print("[eager] LM vs FusedTrainer in turns (fused, eager, eager, fused; "
          "10 steps each): median step ms fused %s, eager %s on %s"
          % (["%.2f" % v for v in turns["fused"]],
             ["%.2f" % v for v in turns["eager"]], card))
    del eager, net, ft, fnet
    return launches, {
        "tokens_per_s": tps, "fused_tokens_per_s": fused_tps,
        "step_ms": step_ms, "step_ms_min": min(times) * 1e3,
        "step_ms_max": max(times) * 1e3, "steps": steps, "losses": losses,
        "vs_fused": {"loss_rel_err": rel_loss, "update_rel_err_max": upd_err,
                     "dropout": "same generator (random.seed before each)"},
        "host": host, "fused_host": fused_host, "turns_ms": turns,
        "profile": profile}


def phase_eager(card, fused_ips, fused_tps):
    """Phase 19: group2ctx across the CPU and the card, then ResNet-50 v1
    and the LM trained through ``autograd.record`` and ``gluon.Trainer``."""
    fp32_exact()
    g2c = _eager_group2ctx()
    conv, conv_nohyb, resnet = _eager_resnet(card, fused_ips)
    lstm, lm = _eager_lm(card, fused_tps)
    for tag, prof in (("resnet50_v1", resnet["profile"]),
                      ("resnet50_v1 not hybridized",
                       resnet["not_hybridized"]["profile"]),
                      ("LM", lm["profile"])):
        groups = prof["device_ms_by_group"]
        upd = sum(v for g, v in groups.items() if g.startswith("optimizer"))
        prof["trainer_update_share"] = upd / prof["step_device_ms"]
        print("[eager] %s step: the device busy %.1f%% (%.2f ms a step), "
              "%d launches a step, the Trainer's update %.3f ms (%.1f%% of "
              "busy) on %s" % (tag, 100 * (1 - prof["idle_share"]),
                               prof["step_device_ms"],
                               prof["launches_per_step"], upd,
                               100 * prof["trainer_update_share"], card))
    return conv, conv_nohyb, lstm, {"group2ctx": g2c, "resnet50_v1": resnet,
                                    "lm": lm}


# --------------------------------------------------------------------------
# phases 2i, 20 and 21: the rest of the op layer, and FCN-8s on VGG-16 (Long,
# Shelhamer and Darrell, "Fully Convolutional Networks for Semantic
# Segmentation", CVPR 2015, as upstream MXNet's example/fcn-xs/
# symbol_fcnxs.py writes it): VGG-16's 13 convolutions (conv1_1 padded by
# 100), fc6 and fc7 as convolutions, 21 PASCAL VOC classes, three
# Deconvolutions and Crops at offsets (5, 5), (9, 9) and (31, 31).  The
# weights are initialised, not the published ImageNet ones; the images are
# synthetic.
FCN = dict(classes=21, widths=(64, 128, 256, 512, 512), fc=4096,
           dropout=0.5, size=500, images=8, epochs=3, batch=1, lr=1e-3,
           momentum=0.9, wd=5e-4, band=24, seed=SEED + 18, cpu_size=192)
FCN_BLOCKS = (2, 2, 3, 3, 3)      # VGG-16's convolutions a block
FCN_IGNORE = 255
FCN_LOSS_RTOL = 1e-4    # first step's loss, card vs CPU, relative
FCN_GRAD_TOL = 1e-3     # its gradients, card vs CPU, in Frobenius norm
FCN_CPU_GRADS = ("conv1_2_weight", "conv5_3_weight", "fc6_weight",
                 "bigscore_weight")
OPS_TOL = 1e-5          # a new op on the card vs the CPU, of max(1, |cpu|)
OPS_SUM_TOL = 1e-4      # the same where a value sums over many products
SAMPLES = 10 ** 6
SAMPLE_MEAN_SE = 6.0    # |mean - mu| within this many standard errors
SAMPLE_VAR_RTOL = 0.02  # |var / sigma² - 1|


def fcn8s_symbol(sym, widths=FCN["widths"], fc=FCN["fc"],
                 classes=FCN["classes"], dropout=FCN["dropout"]):
    """FCN-8s on VGG-16 with any package's ``sym``: 2x2 max pools at
    stride 2 in the default ``valid`` convention, the upsampling
    Deconvolutions without bias, bilinear at initialisation, and the
    pixel-wise ``SoftmaxOutput`` that ignores label 255."""
    data = sym.var("data")
    x, pools = data, []
    for b, (n, c) in enumerate(zip(FCN_BLOCKS, widths), 1):
        for i in range(1, n + 1):
            x = sym.Convolution(x, kernel=(3, 3), num_filter=c,
                                pad=(100, 100) if (b, i) == (1, 1)
                                else (1, 1), name="conv%d_%d" % (b, i))
            x = sym.Activation(x, act_type="relu", name="relu%d_%d" % (b, i))
        x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="pool%d" % b)
        pools.append(x)
    for name, k in (("fc6", 7), ("fc7", 1)):
        x = sym.Convolution(x, kernel=(k, k), num_filter=fc, name=name)
        x = sym.Activation(x, act_type="relu", name="relu" + name[2])
        x = sym.Dropout(x, p=dropout, name="drop" + name[2])
    score = sym.Convolution(x, kernel=(1, 1), num_filter=classes,
                            name="score")

    def upsample(s, k, stride, name):
        return sym.Deconvolution(s, kernel=(k, k), stride=(stride, stride),
                                 num_filter=classes, no_bias=True, name=name)

    def skip(pool, like, offset, name):
        s = sym.Convolution(pool, kernel=(1, 1), num_filter=classes,
                            name="score_" + name)
        return sym.Crop(s, like, offset=offset, name="score_%sc" % name)

    score2 = upsample(score, 4, 2, "score2")
    score4 = upsample(score2 + skip(pools[3], score2, (5, 5), "pool4"), 4,
                      2, "score4")
    big = upsample(score4 + skip(pools[2], score4, (9, 9), "pool3"), 16, 8,
                   "bigscore")
    upscore = sym.Crop(big, data, offset=(31, 31), name="upscore")
    return sym.SoftmaxOutput(upscore, sym.var("softmax_label"),
                             multi_output=True, use_ignore=True,
                             ignore_label=FCN_IGNORE, normalization="valid",
                             name="softmax")


def fcn_initializer(mx):
    """``init.Mixed``: ``Bilinear`` for the three Deconvolutions on the
    diagonal (class i to class i, zero elsewhere), as upstream MXNet's
    example/fcn-xs/init_fcnxs.py sets them (``Bilinear`` alone fills every
    (in, out) pair, so every class gets the same score and the gradient
    below the decoder is exactly zero); ``Xavier`` (gaussian, fan-in,
    magnitude 2) for the rest, zero biases."""

    class DiagonalBilinear(mx.init.Bilinear):
        def _init_weight(self, name, arr):
            super()._init_weight(name, arr)
            w = arr.asnumpy()
            eye = np.eye(w.shape[0], w.shape[1], dtype=w.dtype)
            arr[:] = w * eye[:, :, None, None]

    return mx.init.Mixed(
        [r".*(score2|score4|bigscore)_weight$", ".*"],
        [DiagonalBilinear(),
         mx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2)])


def fcn_images(n, size, seed, classes=FCN["classes"], band=FCN["band"]):
    """(images (n, 3, size, size), labels (n, size, size)) from ``seed``:
    as the repo's example/fcn-xs makes them, rectangles on noise, here of
    the 20 object classes (each its own colour) on background 0, and a
    band of ``band`` rows labelled 255 (ignored) in every image."""
    rng = np.random.RandomState(seed)
    colors = rng.uniform(-1.5, 1.5, (classes, 3)).astype(np.float32)
    x = rng.randn(n, 3, size, size).astype(np.float32) * 0.3
    y = np.zeros((n, size, size), np.float32)
    for i in range(n):
        for _ in range(4):
            c = rng.randint(1, classes)
            h, w = rng.randint(size // 6, size // 2, size=2)
            r, q = rng.randint(0, size - h), rng.randint(0, size - w)
            x[i, :, r:r + h, q:q + w] += colors[c][:, None, None]
            y[i, r:r + h, q:q + w] = c
        b = rng.randint(0, size - band)
        y[i, b:b + band] = FCN_IGNORE
    return x, y


def fcn_3x3_shapes(size=FCN["size"], widths=FCN["widths"]):
    """(name, C, O, H) of FCN-8s's stride-1 pad-1 3x3 convolutions, the
    ones kernels 1 and 2 carry (conv1_1, padded by 100, stays on cuDNN):
    conv1_1 makes ``size + 198`` pixels a side, each pool halves it, odd
    sides rounded down."""
    out, c_in, h = [], 3, size + 198
    for b, (n, c) in enumerate(zip(FCN_BLOCKS, widths), 1):
        for i in range(1, n + 1):
            if (b, i) != (1, 1):
                out.append(("conv%d_%d" % (b, i), c_in, c, h))
            c_in = c
        h //= 2
    return out


def fcn_step_launches(hc, sms, size=FCN["size"], batch=FCN["batch"]):
    """Kernels 1 and 2's launches in one FCN-8s training step, from their
    plans: a forward and a dgrad of kernel 1 a 3x3 convolution, with a split
    sum each where its plan splits, and kernel 2's partial pass and its
    reduction where the plan splits the rows."""
    want = dict.fromkeys(("implicit_gemm_conv", "implicit_gemm_conv "
                          "reduction", "taps_wgrad", "taps_wgrad reduction"),
                         0)
    for _, C, O, H in fcn_3x3_shapes(size):
        M = batch * H * H
        for cin, cout in ((C, O), (O, C)):
            plan = hc.conv_fp32_plan(M, cin, cout, 3, 3, sms)
            want["implicit_gemm_conv"] += 1
            want["implicit_gemm_conv reduction"] += plan.splits > 1
        want["taps_wgrad"] += 1
        want["taps_wgrad reduction"] += \
            hc.wgrad_fp32_plan(M, C, O, 3, 3, sms).splits > 1
    return want


def _fp32_3x3_shape(hc, gen, N, C, O, H, count, name, iters):
    """Kernels 1 and 2 (fp32) at one 3x3 / pad-1 shape of batch ``N`` on
    seeded operands: the forward (C to O) and the dgrad (O to C) on kernel
    1 and the wgrad on kernel 2 against their plain versions, each run
    twice, bit-equal, with the plan's launches; timed (``iters`` calls after
    3 warm-ups) beside the plain version, cuDNN and the bound.  ``ms`` is
    the kernel on operands already in its layout (NHWC, taps), as a step
    calls it; ``wrapper_ms`` is the forward through ``conv3x3_same`` and the
    dgrad with its ``dgrad_taps``, the layout rewrites included.  Returns
    the record and (x NHWC, taps, dy, dgrad taps, forward plan, dgrad
    plan)."""
    dev = gen.device
    x = torch.randn(N, C, H, H, device=dev, generator=gen) \
        .contiguous(memory_format=torch.channels_last)
    w = torch.randn(O, C, 3, 3, device=dev, generator=gen) \
        / math.sqrt(9 * C)
    dy = torch.randn(N, H, H, O, device=dev, generator=gen)
    xh, taps, dtaps = hc._nhwc(x), hc._s1_taps(w, torch.float32), \
        hc.dgrad_taps(w)
    dyn = dy.permute(0, 3, 1, 2)
    label = "C=%d O=%d %dx%d N=%d" % (C, O, H, H, N)
    _, fplan, ferr = _conv_fp32_call(hc, xh, taps, 1, None,
                                     "%s %s" % (name, label))
    _, dplan, derr = _conv_fp32_call(hc, dy, dtaps, 1, None,
                                     "%s dgrad %s" % (name, label))
    _, werr, wscale = _wgrad_fp32_check(hc, xh, dy, hc.S1_PADS, 3, 3,
                                        "%s %s" % (name, label))
    wplan = hc.wgrad_fp32_plan(N * H * H, C, O, 3, 3, _sms(dev),
                               (xh.data_ptr(), dy.data_ptr()))
    flops = 2.0 * N * H * H * C * O * 9
    nbytes = 4.0 * (x.numel() + w.numel() + dy.numel())
    bound_ms, bound_by = _bound(flops, nbytes)
    calls = {
        "forward": (lambda: hc.taps_conv(xh, taps, hc.S1_PADS, 3, 3),
                    lambda: hc.taps_conv_plain(xh, taps, hc.S1_PADS, 3, 3),
                    lambda: F.conv2d(x, w, padding=1)),
        "dgrad": (lambda: hc.taps_conv(dy, dtaps, hc.S1_PADS, 3, 3),
                  lambda: hc.taps_conv_plain(dy, dtaps, hc.S1_PADS, 3, 3),
                  lambda: torch.nn.grad.conv2d_input(x.shape, w, dyn,
                                                     padding=1)),
        "wgrad": (lambda: hc.taps_wgrad(xh, dy, hc.S1_PADS, 3, 3),
                  lambda: hc.taps_wgrad_plain(xh, dy, hc.S1_PADS, 3, 3),
                  lambda: torch.nn.grad.conv2d_weight(x, w.shape, dyn,
                                                      padding=1))}
    wrappers = {"forward": lambda: hc.conv3x3_same(x, w),
                "dgrad": lambda: hc.taps_conv(dy, hc.dgrad_taps(w),
                                              hc.S1_PADS, 3, 3)}
    rec = {"C": C, "O": O, "H": H, "W": H, "N": N,
           "instances_per_step": count, "gflop": flops / 1e9,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "forward": {"tile": list(fplan.tile), "splits": fplan.splits,
                       "max_abs_err": ferr, "tol": KERNEL_TOL},
           "dgrad": {"tile": list(dplan.tile), "splits": dplan.splits,
                     "max_abs_err": derr, "tol": KERNEL_TOL},
           "wgrad": {"tile": wplan.tile, "splits": wplan.splits,
                     "rows": wplan.rows, "max_abs_err": werr,
                     "max_rel_err": werr / wscale, "tol_rel": WGRAD_TOL}}
    for part, (kern, plain, lib) in calls.items():
        rec[part].update(ms=time_ms(kern, iters=iters),
                         plain_ms=time_ms(plain, iters=iters),
                         library_ms=time_ms(lib, iters=iters),
                         bit_equal_rerun=True)
        rec[part]["tflops"] = flops / rec[part]["ms"] / 1e9
        if part in wrappers:
            rec[part]["wrapper_ms"] = time_ms(wrappers[part], iters=iters)
    f, d, g = rec["forward"], rec["dgrad"], rec["wgrad"]
    print("[%s-kernels] %s x%d: forward (plan tile %dx%d, %d splits) err "
          "%.3g, %.4f ms (%.1f TFLOP/s), %.4f with the layout rewrites, "
          "plain %.4f, cuDNN %.4f | dgrad (plan tile %dx%d, %d splits) err "
          "%.3g, %.4f ms (%.1f TFLOP/s), %.4f with its taps, plain %.4f, "
          "cuDNN %.4f | wgrad (tile %d, %d splits of %d rows) err %.3g of "
          "max |dw|, %.4f ms (%.1f TFLOP/s), plain %.4f, cuDNN %.4f | bound "
          "%.4f ms (%s, at %.0f TFLOP/s); reruns bit-equal"
          % (name.lower(), label, count, fplan.tile[0], fplan.tile[1],
             fplan.splits, ferr, f["ms"], f["tflops"], f["wrapper_ms"],
             f["plain_ms"], f["library_ms"], dplan.tile[0], dplan.tile[1],
             dplan.splits, derr, d["ms"], d["tflops"], d["wrapper_ms"],
             d["plain_ms"], d["library_ms"], wplan.tile, wplan.splits,
             wplan.rows, werr / wscale, g["ms"], g["tflops"], g["plain_ms"],
             g["library_ms"], bound_ms, bound_by, PEAK_FP32 / 1e12))
    return rec, (xh, taps, dy, dtaps, fplan, dplan)


def _print_kernel_sums(name, sums, what):
    k1, k2 = sums["k1"], sums["k2"]
    print("[%s-kernels] over one %s: kernel 1 (%d forwards, %d dgrads) %.3f "
          "ms (%.1f TFLOP/s), %.3f with the layout rewrites, plain %.3f, "
          "cuDNN %.3f, bound %.3f | kernel 2 (%d wgrads) %.3f ms (%.1f "
          "TFLOP/s), plain %.3f, cuDNN %.3f, bound %.3f"
          % (name.lower(), what, k1["calls"], k1["calls"], k1["ms"],
             k1["tflops"], k1["wrapper_ms"], k1["plain_ms"],
             k1["library_ms"], k1["bound_ms"], k2["calls"], k2["ms"],
             k2["tflops"], k2["plain_ms"], k2["library_ms"],
             k2["bound_ms"]))


def phase_fcn_kernels():
    """Kernels 1 and 2 (fp32) against their plain versions at FCN-8s's 8
    distinct 3x3 shapes at batch 1 (C 64 at 698 px, odd sides 349, 87 and
    43), each checked and timed (10 calls) by ``_fp32_3x3_shape``.
    Returns the per-shape records."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    gen = torch.Generator(device=torch.device("cuda", 0)) \
        .manual_seed(FCN["seed"])
    counts = {}
    for _, C, O, H in fcn_3x3_shapes():
        counts[(C, O, H)] = counts.get((C, O, H), 0) + 1
    records = []
    for (C, O, H), count in counts.items():
        rec, ops = _fp32_3x3_shape(hc, gen, 1, C, O, H, count, "FCN", 10)
        records.append(rec)
        del ops
        torch.cuda.empty_cache()
    _print_kernel_sums("FCN", fcn_kernel_sums(records),
                       "FCN-8s step (batch 1, 500 px)")
    return records


def fcn_kernel_sums(records):
    """Kernel 1's (forward and dgrad) and kernel 2's (wgrad) times summed
    over one step's calls (FCN-8s's or DenseNet-121's), with their TFLOP/s
    and the largest error; kernel 1's also through its wrappers, with the
    layout rewrites (``wrapper_ms``)."""
    out = {}
    for key, parts in (("k1", ("forward", "dgrad")), ("k2", ("wgrad",))):
        timed = ("ms", "plain_ms", "library_ms") \
            + (("wrapper_ms",) if key == "k1" else ())
        s = {k: sum(r[p][k] * r["instances_per_step"] for r in records
                    for p in parts)
             for k in timed}
        s["calls"] = sum(r["instances_per_step"] for r in records)
        s["bound_ms"] = sum(r["bound_ms"] * r["instances_per_step"]
                            * len(parts) for r in records)
        s["bound_by"] = "operations" if all(
            r["bound_by"] == "operations" for r in records) else "bytes"
        s["tflops"] = sum(r["gflop"] * r["instances_per_step"] * len(parts)
                          for r in records) / s["ms"]
        s["max_abs_err"] = max(r[p]["max_abs_err"] for r in records
                               for p in parts)
        out[key] = s
    return out


# the deterministic new ops of phase 20: (label, op, input shapes (or
# arrays), attrs, differentiate, tolerance of max(1, |cpu|))
def _new_op_cases(rng):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    idx = np.stack([rng.randint(0, 6, 50), rng.randint(0, 7, 50)]) \
        .astype(np.float32)
    uniq = np.unique(idx.T, axis=0).T
    return [
        ("linspace", "_linspace", [], dict(start=-2, stop=3, num=1001), False,
         OPS_TOL),
        ("linspace open", "_linspace",
         [], dict(start=-2, stop=3, num=1000, endpoint=False), False,
         OPS_TOL),
        ("eye", "_eye", [], dict(N=64, M=80, k=3), False, OPS_TOL),
        ("grad_add", "_grad_add", [f(64, 65), f(64, 65)], {}, True, OPS_TOL),
        ("identity_with_attr_like_rhs", "_identity_with_attr_like_rhs",
         [f(64, 65), f(64, 65)], {}, True, OPS_TOL),
        ("histogram", "_histogram", [f(10000)],
         dict(bin_cnt=16, range=(-2.0, 2.0)), False, OPS_TOL),
        ("ravel_multi_index", "_ravel_multi_index", [idx], dict(shape=(6, 7)),
         False, OPS_TOL),
        ("unravel_index", "_unravel_index",
         [rng.randint(0, 42, 50).astype(np.float32)], dict(shape=(6, 7)),
         False, OPS_TOL),
        ("slice_assign", "_slice_assign", [f(8, 9, 10), f(3, 4, 10)],
         dict(begin=(1, 8), end=(7, 0), step=(2, -2)), True, OPS_TOL),
        ("slice_assign_scalar", "_slice_assign_scalar", [f(8, 9)],
         dict(scalar=2.5, begin=(-5,), end=(8,)), True, OPS_TOL),
        ("scatter_set_nd", "_scatter_set_nd",
         [f(6, 7), f(uniq.shape[1]), uniq.astype(np.int64)],
         dict(shape=(6, 7)), True,
         OPS_TOL),
        ("square_sum", "_square_sum", [f(32, 33, 5)], dict(axis=(1,)), True,
         OPS_SUM_TOL),
        ("sparse_adagrad_update", "_sparse_adagrad_update",
         [f(64, 9), f(64, 9), np.abs(f(64, 9))],
         dict(lr=0.1, clip_gradient=1.0, rescale_grad=0.5), False, OPS_TOL),
        ("IdentityAttachKLSparseReg", "IdentityAttachKLSparseReg",
         [1 / (1 + np.exp(-f(16, 32)))], dict(penalty=0.01), True, OPS_TOL),
        ("cast_storage", "cast_storage", [f(16, 17)], {}, True, OPS_TOL),
        ("Deconvolution 16x16 s8", "Deconvolution",
         [f(1, 21, 33, 33), f(21, 21, 16, 16) * 0.1],
         dict(kernel=(16, 16), stride=(8, 8), num_filter=21, no_bias=True),
         True, OPS_SUM_TOL),
        ("Deconvolution target_shape", "Deconvolution",
         [f(2, 8, 9, 11), f(8, 3, 3, 3) * 0.2, f(6)],
         dict(kernel=(3, 3), stride=(2, 2), num_filter=6, num_group=2,
              target_shape=(18, 22)), True, OPS_SUM_TOL),
        ("Crop offset", "Crop", [f(2, 3, 40, 41), f(2, 3, 31, 29)],
         dict(offset=(5, 9), num_args=2), True, OPS_TOL),
        ("Crop center", "Crop", [f(2, 3, 40, 41)],
         dict(h_w=(17, 20), center_crop=True), True, OPS_TOL),
        ("UpSampling nearest", "UpSampling", [f(2, 5, 13, 17)],
         dict(scale=3, sample_type="nearest"), True, OPS_SUM_TOL),
        ("UpSampling bilinear", "UpSampling", [f(2, 5, 13, 17)],
         dict(scale=2, sample_type="bilinear"), True, OPS_SUM_TOL),
    ] + [
        ("LeakyReLU " + act, "LeakyReLU",
         [f(4, 6, 9, 9)] + ([f(6)] if act == "prelu" else []),
         dict(act_type=act), True, OPS_TOL)
        for act in ("leaky", "elu", "selu", "gelu", "prelu", "rrelu")
    ] + [
        ("InstanceNorm", "InstanceNorm", [f(4, 6, 15, 17), f(6), f(6)], {},
         True, OPS_SUM_TOL),
        ("LRN", "LRN", [f(4, 12, 15, 17)], dict(nsize=5), True, OPS_TOL),
        ("SoftmaxActivation instance", "SoftmaxActivation", [f(4, 6, 7)], {},
         True, OPS_TOL),
        ("SoftmaxActivation channel", "SoftmaxActivation", [f(4, 6, 7)],
         dict(mode="channel"), True, OPS_TOL),
        ("Pooling lp 2", "Pooling", [f(2, 4, 17, 19)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="lp",
              p_value=2), True, OPS_TOL),
        ("Pooling lp 3", "Pooling", [f(2, 4, 17, 19)],
         dict(kernel=(2, 2), stride=(2, 2), pool_type="lp", p_value=3,
              pooling_convention="full"), True, OPS_TOL),
    ] + [
        ("L2Normalization " + m, "L2Normalization", [f(4, 6, 9, 10)],
         dict(mode=m), True, OPS_TOL)
        for m in ("instance", "channel", "spatial")
    ] + [
        (name, name, [f(16, 9), f(16, 9)], dict(grad_scale=0.5), True,
         OPS_TOL)
        for name in ("LinearRegressionOutput", "LogisticRegressionOutput",
                     "MAERegressionOutput")
    ]


def _op_results(name, arrays, attrs, device, grad, heads):
    """The visible outputs of op ``name`` on ``device`` and, with
    ``grad``, the gradients of ``sum(out * head)`` in each floating
    input, on the CPU."""
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op(name)
    a = op.parse_attrs(dict(attrs))
    if "num_args" in op.params:
        a["num_args"] = len(arrays)
    if not arrays:
        a["__device__"] = device
    ts = [torch.as_tensor(x, device=device) for x in arrays]
    if grad:
        for t in ts:
            t.requires_grad_(t.is_floating_point())
    with torch.set_grad_enabled(grad):
        outs = op.fn(a, *(([None] if op.needs_rng else []) + ts))
        outs = outs if isinstance(outs, tuple) else (outs,)
        vis = outs[:op.num_visible_outputs(a)]
        res = [o.detach().cpu() for o in vis]
        if grad:
            leaves = [t for t in ts if t.requires_grad]
            loss = sum((o.float() * h.to(device)).sum()
                       for o, h in zip(vis, heads(vis)))
            res += [g.cpu() if g is not None else torch.zeros(())
                    for g in torch.autograd.grad(loss, leaves,
                                                 allow_unused=True)]
    return res


def phase_new_ops(card):
    """Each deterministic op of the op layer's rest (``_linspace``,
    ``_eye``, ``misc_parity``'s, ``nn.py``'s 20 and ``Pooling(pool_type=
    'lp')``) on the card against the port's own CPU result, outputs and
    gradients; then every sampler at 10^6 draws on the card: mean within
    SAMPLE_MEAN_SE standard errors and variance within SAMPLE_VAR_RTOL of
    the distribution's, one seed giving the same draws twice."""
    import mxnet_tpu_torch as mx
    fp32_exact()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(FCN["seed"])
    errs = {}
    for label, name, arrays, attrs, grad, tol in _new_op_cases(rng):
        head_rng = np.random.RandomState(7)

        def heads(vis, _r=head_rng):
            return [torch.as_tensor(_r.randn(*o.shape).astype(np.float32))
                    for o in vis]

        want = _op_results(name, arrays, attrs, torch.device("cpu"), grad,
                           heads)
        head_rng.seed(7)
        got = _op_results(name, arrays, attrs, dev, grad, heads)
        check(len(got) == len(want), "%s: %d results on the card, %d on "
              "the CPU" % (label, len(got), len(want)))
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, "%s: %s %s on "
                  "the card, %s %s on the CPU" % (label, tuple(g.shape),
                                                  g.dtype, tuple(w.shape),
                                                  w.dtype))
            if w.numel():
                e = (g.double() - w.double()).abs().max().item() / max(
                    1.0, w.double().abs().max().item())
                err = max(err, e)
        check(err <= tol, "%s on the card disagrees with the CPU: %.3g > %g"
              % (label, err, tol))
        errs[label] = err
    print("[new-ops] %d deterministic cases on the card match the port on "
          "the CPU (outputs and gradients; %g, sums %g, of max(1, |cpu|)): "
          "%s" % (len(errs), OPS_TOL, OPS_SUM_TOL,
                  ", ".join("%s %.2g" % kv for kv in errs.items())))
    gpu = mx.gpu(0)
    n = SAMPLES
    cases = [
        ("uniform", lambda: mx.nd.random.uniform(-1, 3, shape=(n,), ctx=gpu),
         1.0, 16.0 / 12),
        ("normal", lambda: mx.nd.random.normal(2, 3, shape=(n,), ctx=gpu),
         2.0, 9.0),
        ("gamma", lambda: mx.nd.random.gamma(2.5, 1.5, shape=(n,), ctx=gpu),
         3.75, 2.5 * 1.5 ** 2),
        ("exponential", lambda: mx.nd.random.exponential(2.0, shape=(n,),
                                                         ctx=gpu), 0.5, 0.25),
        ("poisson", lambda: mx.nd.random.poisson(4.0, shape=(n,), ctx=gpu),
         4.0, 4.0),
        ("negative_binomial", lambda: mx.nd.random.negative_binomial(
            3, 0.4, shape=(n,), ctx=gpu), 4.5, 11.25),
        ("generalized_negative_binomial",
         lambda: mx.nd.random.generalized_negative_binomial(
             2.0, 0.5, shape=(n,), ctx=gpu), 2.0, 4.0),
        ("randint", lambda: mx.nd.random.randint(-5, 7, shape=(n,), ctx=gpu),
         0.5, (12 ** 2 - 1) / 12.0),
        ("sample_normal", lambda: mx.nd.random.normal(
            mx.nd.array([2.0], ctx=gpu), mx.nd.array([3.0], ctx=gpu),
            shape=(n,))[0], 2.0, 9.0),
        ("sample_uniform", lambda: mx.nd.random.uniform(
            mx.nd.array([-1.0], ctx=gpu), 3.0, shape=(n,))[0], 1.0,
         16.0 / 12),
        ("sample_gamma", lambda: mx.nd.random.gamma(
            mx.nd.array([2.5], ctx=gpu), 1.5, shape=(n,))[0], 3.75,
         2.5 * 1.5 ** 2),
        ("sample_exponential", lambda: mx.nd.sample_exponential(
            mx.nd.array([2.0], ctx=gpu), shape=(n,))[0], 0.5, 0.25),
        ("sample_poisson", lambda: mx.nd.sample_poisson(
            mx.nd.array([4.0], ctx=gpu), shape=(n,))[0], 4.0, 4.0),
        ("sample_negative_binomial", lambda: mx.nd.sample_negative_binomial(
            mx.nd.array([3.0], ctx=gpu), mx.nd.array([0.4], ctx=gpu),
            shape=(n,))[0], 4.5, 11.25),
        ("sample_generalized_negative_binomial",
         lambda: mx.nd.sample_generalized_negative_binomial(
             mx.nd.array([2.0], ctx=gpu), mx.nd.array([0.5], ctx=gpu),
             shape=(n,))[0], 2.0, 4.0),
    ]
    moments = {}
    for name, draw, mu, var in cases:
        mx.random.seed(FCN["seed"])
        a = draw()._data
        mx.random.seed(FCN["seed"])
        b = draw()._data
        check(a.device.type == "cuda" and a.numel() == n,
              "%s drew %d values on %s" % (name, a.numel(), a.device))
        check(torch.equal(a, b), "%s: one seed gave other draws" % name)
        x = a.double()
        m, v = x.mean().item(), x.var().item()
        check(abs(m - mu) <= SAMPLE_MEAN_SE * math.sqrt(var / n)
              and abs(v / var - 1) <= SAMPLE_VAR_RTOL,
              "%s: mean %.5f, var %.5f at %d draws; the distribution's %.5f "
              "and %.5f" % (name, m, v, n, mu, var))
        moments[name] = (m, v)
    p = torch.tensor([0.1, 0.2, 0.3, 0.4])
    mx.random.seed(FCN["seed"])
    draws, logp = mx.nd.random.multinomial(mx.nd.array(p.numpy(), ctx=gpu),
                                           shape=(n,), get_prob=True)
    freq = torch.bincount(draws._data.long().cpu(), minlength=4).double() / n
    se = (p.double() * (1 - p.double()) / n).sqrt()
    check(bool(((freq - p.double()).abs() <= SAMPLE_MEAN_SE * se).all()),
          "multinomial frequencies %s for %s" % (freq.tolist(), p.tolist()))
    check(torch.allclose(logp._data.cpu(), p.log()[draws._data.long().cpu()]),
          "multinomial's log-probabilities are not log(p[draw])")
    mx.random.seed(FCN["seed"])
    base = mx.nd.arange(0, n, ctx=gpu)
    s1 = mx.nd.random.shuffle(base)._data
    mx.random.seed(FCN["seed"])
    s2 = mx.nd.random.shuffle(base)._data
    check(torch.equal(s1, s2) and torch.equal(s1.sort().values, base._data)
          and not torch.equal(s1, base._data),
          "shuffle is not a seeded permutation")
    moments["multinomial"] = freq.tolist()
    print("[new-ops] %d samplers at %d draws on the card: mean within %g "
          "standard errors, variance within %g; one seed gives the same "
          "draws twice; multinomial's frequencies and log(p[draw]); shuffle "
          "a permutation (%s): %s"
          % (len(cases) + 2, n, SAMPLE_MEAN_SE, SAMPLE_VAR_RTOL, card,
             ", ".join("%s %s" % (k, ("mean %.4f var %.4f" % v)
                                  if isinstance(v, tuple) else v)
                       for k, v in moments.items())))
    return {"deterministic_errs": errs, "sampler_moments": moments}


def fcn_metrics(mx):
    """Two metrics computed on the card from the SoftmaxOutput's
    probabilities: the mean cross-entropy of the valid pixels (every
    batch's value kept, read once at the end), and the share of valid
    pixels whose most likely class is the label."""

    def picked(p, lab):
        return p.gather(1, lab.clamp(0, p.shape[1] - 1).unsqueeze(1)) \
            .squeeze(1)

    class PixelCE(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("pixel-ce")
            self.values = []

        def update(self, labels, preds):
            p, lab = preds[0]._data, labels[0]._data.long()
            valid = lab != FCN_IGNORE
            ce = -(picked(p, lab).clamp_min(1e-30).log() * valid).sum() \
                / valid.sum().clamp_min(1)
            self.values.append(ce.detach())
            self.sum_metric += ce.detach()
            self.num_inst += 1

        def get(self):
            if not self.num_inst:
                return self.name, float("nan")
            return self.name, float(self.sum_metric) / self.num_inst

    class PixelAccuracy(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("pixel-accuracy")

        def update(self, labels, preds):
            p, lab = preds[0]._data, labels[0]._data.long()
            valid = lab != FCN_IGNORE
            self.sum_metric += int(((p.argmax(1) == lab) & valid).sum())
            self.num_inst += int(valid.sum())

    return PixelCE(), PixelAccuracy()


def _fcn_loss(probs, label):
    p, lab = probs.double(), label.long()
    valid = lab != FCN_IGNORE
    picked = p.gather(1, lab.clamp(0, p.shape[1] - 1).unsqueeze(1)).squeeze(1)
    return float(-(picked.log() * valid).sum() / valid.sum())


def _fcn_vs_cpu(mx):
    """The first training step of FCN-8s at full width on a 1 x 3 x 192 x
    192 image, on the card and on the CPU from the same initial weights,
    through ``Module``'s eager arm (forward, backward): the loss within
    FCN_LOSS_RTOL and the gradients of conv1_2, conv5_3, fc6 and the 16x16
    deconvolution within FCN_GRAD_TOL of the CPU's in norm.  Dropout is
    off here (p 0): the card's and the CPU's generators draw other masks."""
    size = FCN["cpu_size"]
    x, y = fcn_images(1, size, FCN["seed"] + 1)
    sym = fcn8s_symbol(mx.sym, dropout=0.0)
    res = []
    params = None
    for ctx in (mx.cpu(), mx.gpu(0)):
        mod = mx.mod.Module(sym, context=[ctx])
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        if params is None:
            mx.random.seed(FCN["seed"])
            mod.init_params(initializer=fcn_initializer(mx))
            params = mod.get_params()
        else:
            mod.init_params(arg_params=params[0], aux_params=params[1])
        batch = mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                [mx.nd.array(y, ctx=ctx)])
        t0 = time.perf_counter()
        mod.forward(batch, is_train=True)
        mod.backward()
        out = mod.get_outputs()[0]
        grads = mod._exec_group.execs[0].grad_dict
        res.append((
            _fcn_loss(out._data, batch.label[0]._data),
            {k: grads[k]._data.double().cpu() for k in FCN_CPU_GRADS},
            time.perf_counter() - t0))
        del mod, batch, out, grads
    (lc, gc_, tc), (lg, gg, tg) = res
    loss_err = abs(lg - lc) / abs(lc)
    grad_errs = {k: float((gg[k] - gc_[k]).norm() / gc_[k].norm())
                 for k in FCN_CPU_GRADS}
    print("[fcn-vs-cpu] first step at full width, 1 x 3 x %d x %d, dropout "
          "off: loss %.7f on the card, %.7f on the CPU (rel err %.3g, tol "
          "%g); gradient errors in norm (tol %g): %s; step %.2f s on the CPU"
          % (size, size, lg, lc, loss_err, FCN_LOSS_RTOL, FCN_GRAD_TOL,
             ", ".join("%s %.3g" % kv for kv in grad_errs.items()), tc))
    check(loss_err <= FCN_LOSS_RTOL, "FCN-8s's first loss on the card is "
          "%.3g from the CPU's (tol %g)" % (loss_err, FCN_LOSS_RTOL))
    check(all(e <= FCN_GRAD_TOL for e in grad_errs.values()),
          "FCN-8s's first gradients on the card differ from the CPU's: %s "
          "(tol %g)" % (grad_errs, FCN_GRAD_TOL))
    return {"loss_card": lg, "loss_cpu": lc, "loss_rel_err": loss_err,
            "grad_rel_errs": grad_errs, "size": size}


def _fcn_group(name):
    kind = _k1_kind(name)
    if kind is not None:
        return "kernel 1 (fp32)" if kind == "fp32" else "kernel 1 bf16"
    return _train_group(name)


def phase_fcn(card):
    """FCN-8s on VGG-16 at full width through ``Module.fit`` on the card
    (see the module docstring, phase 21); returns kernels 1 and 2's
    launches in ``fit`` and the phase's record."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    cpu_check = _fcn_vs_cpu(mx)
    gpu = mx.gpu(0)
    n, size = FCN["images"], FCN["size"]
    x, y = fcn_images(n, size, FCN["seed"])
    it = mx.io.NDArrayIter(x, y, batch_size=FCN["batch"],
                           label_name="softmax_label", ctx=gpu)
    sym = fcn8s_symbol(mx.sym)
    mod = mx.mod.Module(sym, context=[gpu])
    mod.bind(it.provide_data, it.provide_label)
    arg_shapes, out_shapes, _ = sym.infer_shape(data=(1, 3, size, size))
    n_params = sum(int(np.prod(s)) for k, s in zip(sym.list_arguments(),
                                                   arg_shapes)
                   if k not in ("data", "softmax_label"))
    check(out_shapes[0] == (1, FCN["classes"], size, size),
          "FCN-8s's output is %s" % (out_shapes[0],))
    t0 = time.perf_counter()
    mx.random.seed(FCN["seed"])
    mod.init_params(initializer=fcn_initializer(mx))
    init_s = time.perf_counter() - t0
    want = fcn_step_launches(hc, _sms(torch.device("cuda", 0)))
    loss, accuracy = fcn_metrics(mx)
    per_step = []

    def on_batch(_param):
        per_step.append(_conv_counts(hc))

    torch.cuda.reset_peak_memory_stats()
    _zero_conv_counts(hc)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=FCN["epochs"], optimizer="sgd",
            optimizer_params={"learning_rate": FCN["lr"],
                              "momentum": FCN["momentum"], "wd": FCN["wd"]},
            eval_metric=loss, batch_end_callback=on_batch, overlap_depth=0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _conv_counts(hc)
    steps = n * FCN["epochs"] // FCN["batch"]
    check(len(per_step) == steps, "fit ran %d steps, expected %d"
          % (len(per_step), steps))
    prev = dict.fromkeys(want, 0)
    for i, c in enumerate(per_step):
        step = {k: c[k] - prev[k] for k in want}
        check(step == want, "FCN-8s step %d launched %s of kernels 1 and 2, "
              "the plans say %s" % (i, step, want))
        check(c["taps_conv_bf16"] == 0 and c["taps_wgrad_bf16"] == 0,
              "FCN-8s launched the bf16 kernels")
        prev = c
    losses = [float(v) for v in loss.values]
    epochs = [float(np.mean(losses[e * n:(e + 1) * n]))
              for e in range(FCN["epochs"])]
    check(all(math.isfinite(v) for v in losses), "FCN-8s's loss is not "
          "finite: %s" % losses)
    check(epochs[-1] < epochs[0], "FCN-8s's loss did not fall: epoch means "
          "%s" % epochs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("[fcn] FCN-8s (VGG-16, %d classes, %.1f M parameters) through "
          "Module.fit, 1 x 3 x %d x %d, SGD lr %g momentum %g wd %g, %d "
          "epochs of %d images (%d steps) in %.2f s (init %.2f s), peak %.2f "
          "GB on %s" % (FCN["classes"], n_params / 1e6, size, size,
                        FCN["lr"], FCN["momentum"], FCN["wd"],
                        FCN["epochs"], n, steps, fit_s, init_s, peak_gb,
                        card))
    print("[fcn] loss a step: %s; epoch means %s"
          % (", ".join("%.4f" % v for v in losses),
             ", ".join("%.4f" % v for v in epochs)))
    print("[fcn] kernels 1 and 2 a step (the plans'): %s; in fit: %s"
          % (want, launches))
    acc = mod.score(it, accuracy)[0][1]
    probs = mod.predict(it)
    check(tuple(probs.shape) == (n, FCN["classes"], size, size)
          and bool(torch.isfinite(probs._data).all()),
          "predict gave %s, finite %s" % (tuple(probs.shape),
                                          bool(torch.isfinite(probs._data)
                                               .all())))
    sums = probs._data.sum(1)
    check(bool(((sums - 1).abs() < 1e-4).all()), "predict's probabilities "
          "do not sum to 1")
    print("[fcn] score: pixel accuracy %.4f over %d images; predict %s, "
          "finite, each pixel's probabilities summing to 1"
          % (acc, n, tuple(probs.shape)))
    del probs, sums
    it.reset()
    batch = next(iter(it))

    def step():
        mod.forward_backward(batch)
        mod.update()

    times = timed_steps(step, timed=5)
    step_ms = float(np.median(times)) * 1e3
    kernels, wall_ms = profiled_kernels(step, 2, "fcn-profile")
    groups, counts, names = {}, {}, {}
    for e in kernels:
        g = _fcn_group(e.name)
        us = e.time_range.elapsed_us()
        groups[g] = groups.get(g, 0.0) + us
        counts[g] = counts.get(g, 0) + 1
        names[e.name] = names.get(e.name, 0.0) + us
    device_ms = sum(groups.values()) / 2 / 1e3
    check(device_ms > 0, "the profiler recorded no device time")
    busy = min(1.0, device_ms / step_ms)
    print("[fcn-profile] one FCN-8s step at %d px: %.2f ms (%.2f images/s), "
          "%.2f ms device busy (%.1f%% busy), %.2f ms wall profiled, %d "
          "launches a step on %s" % (size, step_ms, 1e3 / step_ms, device_ms,
                                     100 * busy, wall_ms, len(kernels) // 2,
                                     card))
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[fcn-profile]   %-36s %8.3f ms/step (%.1f%%), %4d launches"
              % (g, us / 2 / 1e3, 100.0 * us / 2 / 1e3 / device_ms,
                 counts[g] // 2))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    for name, us in top:
        print("[fcn-profile]   top: %8.3f ms/step  %s" % (us / 2 / 1e3,
                                                         name[:110]))
    del mod, it
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {
        "steps": steps, "step_launches": want, "losses": losses,
        "epoch_means": epochs, "pixel_accuracy": acc, "fit_s": fit_s,
        "step_ms": step_ms, "images_per_s": 1e3 / step_ms,
        "device_ms": device_ms, "busy_share": busy, "peak_gb": peak_gb,
        "groups_ms": {g: us / 2 / 1e3 for g, us in groups.items()},
        "top_ops_ms": {k: us / 2 / 1e3 for k, us in top},
        "params": n_params, "cpu_check": cpu_check}


# --------------------------------------------------------------------------
DENSE = dict(batch=32, size=224, classes=1000, C=128, O=32, seed=19,
             lr=0.0125, momentum=0.9, wd=1e-4, workers=4, subset=64,
             epochs=5, cpu_batch=2, images=1024,
             mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
# DenseNet-121's 3x3 / pad-1 convolutions, 128 to 32 channels: (H = W,
# instances a step), 58 in all
DENSENET_3X3 = [(56, 6), (28, 12), (14, 24), (7, 16)]
DENSE_LOSS_RTOL = 1e-4   # first step's mean loss, card vs CPU, relative
DENSE_UPDATE_TOL = 0.05  # each weight's first update, card vs CPU, in norm
DENSE_LOGIT_TOL = 1e-5   # reloaded / exported logits vs the trained net's,
                         # of the largest |logit|
ZOO_TOL = 1e-4           # a zoo net's card logits vs the CPU's, of max |logit|
# benchmark_score.py's default networks (batch 1 and 32), then one net of
# each other family (batch 32), with their image sides
ZOO_DEFAULT = ("resnet18_v1", "resnet50_v1", "mobilenet1_0", "squeezenet1_0")
ZOO_MORE = (("resnet50_v2", 224), ("vgg16_bn", 224), ("alexnet", 224),
            ("densenet121", 224), ("inception_v3", 299),
            ("mobilenet_v2_1_0", 224))
# the nets whose routed 3x3s must launch kernel 1
ZOO_KERNEL1 = ("resnet18_v1", "squeezenet1_0", "vgg16_bn", "densenet121",
               "inception_v3")
DATALOADER_THREADS = "dataloader-worker"


def densenet_step_launches(hc, sms, batch=DENSE["batch"]):
    """Kernels 1 and 2's launches in one DenseNet-121 training step, from
    their plans: a forward (128 to 32 channels) and a dgrad (32 to 128) of
    kernel 1 a 3x3, each with its split sum where its plan splits, and
    kernel 2's partial pass and its reduction where the plan splits."""
    want = dict.fromkeys(("implicit_gemm_conv", "implicit_gemm_conv "
                          "reduction", "taps_wgrad", "taps_wgrad reduction"),
                         0)
    C, O = DENSE["C"], DENSE["O"]
    for H, count in DENSENET_3X3:
        M = batch * H * H
        for cin, cout in ((C, O), (O, C)):
            want["implicit_gemm_conv"] += count
            want["implicit_gemm_conv reduction"] += count * (
                hc.conv_fp32_plan(M, cin, cout, 3, 3, sms).splits > 1)
        want["taps_wgrad"] += count
        want["taps_wgrad reduction"] += count * (
            hc.wgrad_fp32_plan(M, C, O, 3, 3, sms).splits > 1)
    return want


def _forced_conv_tiles(hc, a, t, base, label):
    """Kernel 1 fp32 at each tile with one split and with ``base``'s
    splits, each checked against the plain version and timed: where the
    plan's pick stands among them."""
    N, H, W, C = a.shape
    rows = []
    for tile in hc._CONV_FP32_TILES:
        for splits in sorted({1, base.splits}):
            plan = hc.conv_fp32_plan(N * H * W, C, t.shape[2], 3, 3,
                                     _sms(a.device),
                                     (a.data_ptr(), t.data_ptr(), 0),
                                     tile=tile[:2], splits=splits)
            _conv_fp32_call(hc, a, t, 1, plan, "%s tile %dx%d %d splits"
                            % ((label,) + tile[:2] + (splits,)))
            rows.append({"tile": list(tile[:2]), "splits": splits,
                         "ms": time_ms(lambda: hc._taps_conv_cuda(
                             a, t, hc.S1_PADS, 3, 3, 1, plan=plan)),
                         "plan": (tuple(tile[:2]) == tuple(base.tile)
                                  and splits == base.splits)})
    return rows


def phase_densenet_kernels():
    """Kernels 1 and 2 (fp32) against their plain versions at DenseNet-121's
    3x3 shapes at batch 32 (C 128, O 32 at 56, 28, 14 and 7 px; the dgrad C
    32, O 128), each checked and timed (20 calls after 3 warm-ups) by
    ``_fp32_3x3_shape``; each tile forced beside the plan's pick; one
    misaligned operand a kernel.  Returns (per-shape records, misaligned
    errors)."""
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    gen = torch.Generator(device=torch.device("cuda", 0)) \
        .manual_seed(DENSE["seed"])
    N, C, O = DENSE["batch"], DENSE["C"], DENSE["O"]
    records, misaligned = [], {}
    for H, count in DENSENET_3X3:
        rec, (xh, taps, dy, dtaps, fplan, dplan) = _fp32_3x3_shape(
            hc, gen, N, C, O, H, count, "DenseNet", 20)
        label = "C=%d O=%d %dx%d N=%d" % (C, O, H, H, N)
        if H == 14:
            # the element paths: an operand 4 bytes off a 16-byte boundary
            xm, dym = _at_offset_1(xh), _at_offset_1(dy)
            _, p, misaligned["forward " + label] = _conv_fp32_call(
                hc, xm, taps, 1, None, "DenseNet offset 1 " + label)
            check(not p.vec, "kernel 1 took the 16-byte path at offset 1")
            _, p, misaligned["dgrad " + label] = _conv_fp32_call(
                hc, dym, dtaps, 1, None, "DenseNet dgrad offset 1 " + label)
            check(not p.vec, "kernel 1 took the 16-byte path at offset 1")
            _, e, s = _wgrad_fp32_check(hc, xm, dy, hc.S1_PADS, 3, 3,
                                        "DenseNet offset 1 " + label)
            misaligned["wgrad " + label] = e / s
            del xm, dym
        rec["forward"]["forced"] = _forced_conv_tiles(
            hc, xh, taps, fplan, "DenseNet " + label)
        rec["dgrad"]["forced"] = _forced_conv_tiles(
            hc, dy, dtaps, dplan, "DenseNet dgrad " + label)
        records.append(rec)
        for part in ("forward", "dgrad"):
            print("[densenet-kernels]   %s %s forced: %s" % (
                label, part, ", ".join(
                    "%dx%d/%d %.4f ms%s" % (r["tile"][0], r["tile"][1],
                                            r["splits"], r["ms"],
                                            " (plan)" if r["plan"] else "")
                    for r in rec[part]["forced"])))
        del xh, taps, dy, dtaps
        torch.cuda.empty_cache()
    print("[densenet-kernels] misaligned (offset 1, element paths): %s"
          % ", ".join("%s %.3g" % kv for kv in misaligned.items()))
    _print_kernel_sums("DenseNet", fcn_kernel_sums(records),
                       "DenseNet-121 step (batch 32, 224 px)")
    return records, misaligned


def _densenet121(mx, classes=DENSE["classes"]):
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with mx.name.NameManager():
        return vision.get_model("densenet121", classes=classes)


def _dense_pipeline(mx, train=True):
    """The training transforms (a random 224 crop of 8-100% of the area,
    a random mirror, ImageNet's mean and std), or with ``train=False`` the
    centred 224 crop."""
    T = mx.gluon.data.vision.transforms
    crop = [T.RandomResizedCrop(DENSE["size"]), T.RandomFlipLeftRight()] \
        if train else [T.CenterCrop(DENSE["size"])]
    return T.Compose(crop + [T.ToTensor(),
                             T.Normalize(DENSE["mean"], DENSE["std"])])


def _dataloader_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(DATALOADER_THREADS)]


def _check_no_loader_threads(what):
    check(not _dataloader_threads(), "%s left DataLoader threads alive: %s"
          % (what, _dataloader_threads()))


def _dense_step(net, batch):
    """An imperative step with ``Trainer("nag")`` at DENSE's learning rate,
    momentum and weight decay."""
    return _EagerStep(net, batch, DENSE["lr"], DENSE["momentum"], "nag",
                      DENSE["wd"])


def _dense_vs_cpu(mx, tmp):
    """The first training step of full-depth DenseNet-121 at batch 2 x 224
    on the card and on the CPU from the same weights (``save_parameters``
    on the CPU, ``load_parameters`` onto the card) and the same batch:
    the mean loss within DENSE_LOSS_RTOL, every weight's update (conv and
    dense, 121) within DENSE_UPDATE_TOL of its norm."""
    n = DENSE["cpu_batch"]
    r = np.random.default_rng(DENSE["seed"] + 1)
    x = r.standard_normal((n, 3, DENSE["size"], DENSE["size"])) \
        .astype(np.float32)
    y = r.integers(0, DENSE["classes"], (n,)).astype(np.float32)
    path = os.path.join(tmp, "densenet121-first.params")
    res = []
    for ctx in (mx.cpu(), mx.gpu(0)):
        net = _densenet121(mx)
        if ctx == mx.cpu():
            mx.random.seed(DENSE["seed"])
            net.initialize(mx.init.Xavier(), ctx=ctx)
            net(mx.nd.array(x, ctx=ctx))
            net.save_parameters(path)
        else:
            net.load_parameters(path, ctx=ctx)
        net.hybridize()
        weights = sorted(k for k in net.collect_params()
                         if k.endswith("_weight"))
        w0 = {k: net.collect_params()[k].data().asnumpy() for k in weights}
        step = _dense_step(net, n)
        t0 = time.perf_counter()
        loss = _mean_loss(step.step(mx.nd.array(x, ctx=ctx),
                                    mx.nd.array(y, ctx=ctx)))
        secs = time.perf_counter() - t0
        res.append((loss, {k: net.collect_params()[k].data().asnumpy()
                           - w0[k] for k in weights}, secs))
        del net, step
    (lc, uc, tc), (lg, ug, tg) = res
    loss_err = abs(lg - lc) / abs(lc)
    upd = {k: float(np.linalg.norm(ug[k] - uc[k]) / np.linalg.norm(uc[k]))
           for k in uc}
    worst = max(upd, key=upd.get)
    print("[densenet-vs-cpu] first step of full-depth DenseNet-121, %d x 3 x "
          "%d x %d, Trainer('nag'): loss %.7f on the card, %.7f on the CPU "
          "(rel err %.3g, tol %g); %d weight updates within %.3g of their "
          "norm (worst %s; tol %g; median %.3g); step %.2f s on the CPU, "
          "%.2f s on the card (first, with its graph)"
          % (n, DENSE["size"], DENSE["size"], lg, lc, loss_err,
             DENSE_LOSS_RTOL, len(upd), upd[worst], worst, DENSE_UPDATE_TOL,
             float(np.median(list(upd.values()))), tc, tg))
    check(loss_err <= DENSE_LOSS_RTOL, "DenseNet-121's first loss on the "
          "card is %.3g from the CPU's (tol %g)" % (loss_err,
                                                     DENSE_LOSS_RTOL))
    check(upd[worst] <= DENSE_UPDATE_TOL, "DenseNet-121's first update of "
          "%s on the card is %.3g from the CPU's in norm (tol %g)"
          % (worst, upd[worst], DENSE_UPDATE_TOL))
    return {"loss_card": lg, "loss_cpu": lc, "loss_rel_err": loss_err,
            "update_rel_err_max": upd[worst], "update_worst": worst,
            "update_rel_err_median": float(np.median(list(upd.values()))),
            "cpu_step_s": tc, "batch": n}


def _dense_group(name):
    kind = _k1_kind(name)
    if kind is not None:
        return "kernel 1 (fp32)" if kind == "fp32" else "kernel 1 bf16"
    if "CatArray" in name:
        return "concatenation"
    return _train_group(name)


def _dense_profile(card, step, step_ms, tag, batch):
    """Device time by group, launches and the busy share of two calls of
    ``step`` under torch.profiler, against ``step_ms`` unprofiled."""
    kernels, wall_ms = profiled_kernels(step, 2, tag)
    groups, counts, names = {}, {}, {}
    for e in kernels:
        g = _dense_group(e.name)
        us = e.time_range.elapsed_us()
        groups[g] = groups.get(g, 0.0) + us
        counts[g] = counts.get(g, 0) + 1
        names[e.name] = names.get(e.name, 0.0) + us
    device_ms = sum(groups.values()) / 2 / 1e3
    check(device_ms > 0, "the profiler recorded no device time")
    busy = min(1.0, device_ms / step_ms)
    print("[%s] one batch-%d step: %.2f ms, %.2f ms device busy (%.1f%% "
          "busy, %.1f%% idle), %.2f ms wall profiled, %d launches a step on "
          "%s" % (tag, batch, step_ms, device_ms, 100 * busy,
                  100 * (1 - busy), wall_ms, len(kernels) // 2, card))
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print("[%s]   %-36s %8.3f ms/step (%.1f%%), %4d launches"
              % (tag, g, us / 2 / 1e3, 100.0 * us / 2 / 1e3 / device_ms,
                 counts[g] // 2))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    for name, us in top:
        print("[%s]   top: %8.3f ms/step  %s" % (tag, us / 2 / 1e3,
                                                name[:110]))
    return {"step_ms": step_ms, "device_ms": device_ms, "busy_share": busy,
            "idle_share": 1 - busy, "step_wall_ms_profiled": wall_ms,
            "launches_per_step": len(kernels) // 2,
            "device_ms_by_group": {g: us / 2 / 1e3
                                   for g, us in groups.items()},
            "launches_by_group": {g: c // 2 for g, c in counts.items()},
            "top_ops_ms": {k: us / 2 / 1e3 for k, us in top}}


def _rel_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _dense_reloads(mx, net, xb, tmp):
    """The trained net's logits on ``xb`` (inference), then those of a
    fresh densenet121 on the CPU after ``load_parameters`` of the card's
    ``save_parameters``, of a fresh one on the card likewise, and of
    ``SymbolBlock.imports`` of the card's ``export``: each within
    DENSE_LOGIT_TOL of the largest |logit|."""
    gpu = mx.gpu(0)
    want = net(xb.as_in_context(gpu)).asnumpy()
    path = os.path.join(tmp, "densenet121-trained.params")
    net.save_parameters(path)
    net.export(os.path.join(tmp, "densenet121"), epoch=1)
    got = {}
    for name, ctx in (("load_parameters on the CPU", mx.cpu()),
                      ("load_parameters on the card", gpu)):
        fresh = _densenet121(mx)
        fresh.load_parameters(path, ctx=ctx)
        got[name] = fresh(xb.as_in_context(ctx)).asnumpy()
        del fresh
    sb = mx.gluon.SymbolBlock.imports(
        os.path.join(tmp, "densenet121-symbol.json"), ["data"],
        os.path.join(tmp, "densenet121-0001.params"), ctx=gpu)
    got["export -> SymbolBlock.imports on the card"] = \
        sb(xb.as_in_context(gpu)).asnumpy()
    errs = {k: _rel_max(v, want) for k, v in got.items()}
    print("[densenet] the trained net's logits on %d images (max |logit| "
          "%.4g) reproduced, error of the largest |logit| (tol %g): %s"
          % (xb.shape[0], float(np.abs(want).max()), DENSE_LOGIT_TOL,
             ", ".join("%s %.3g" % kv for kv in errs.items())))
    check(all(e <= DENSE_LOGIT_TOL for e in errs.values()),
          "reloaded DenseNet-121 logits differ: %s (tol %g)"
          % (errs, DENSE_LOGIT_TOL))
    return errs


def phase_densenet(card):
    """DenseNet-121 at full width through DataLoader and gluon.Trainer on
    the card (see the module docstring, phase 22); returns kernels 1 and
    2's launches over the run and the phase's record."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import (BatchSampler, DataLoader,
                                            RandomSampler)
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    gpu = mx.gpu(0)
    batch = DENSE["batch"]
    want = densenet_step_launches(hc, _sms(torch.device("cuda", 0)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_densenet_") as tmp:
        cpu_check = _dense_vs_cpu(mx, tmp)
        t0 = time.perf_counter()
        rec, _, _ = write_imgrec(os.path.join(tmp, "synthetic"),
                                 DENSE["images"], DENSE["seed"])
        write_s = time.perf_counter() - t0
        ds = ImageRecordDataset(rec).transform_first(_dense_pipeline(mx))
        loader = DataLoader(ds, batch_size=batch, shuffle=True,
                            num_workers=DENSE["workers"],
                            last_batch="discard")
        net = _densenet121(mx)
        mx.random.seed(DENSE["seed"])
        net.initialize(mx.init.Xavier(), ctx=gpu)
        net.hybridize()
        step = _dense_step(net, batch)
        per_step, losses = [], []

        def counted(x, y):
            before = _conv_counts(hc)
            loss = step.step(x, y)
            after = _conv_counts(hc)
            per_step.append({k: after[k] - before[k]
                             for k in after})
            return loss

        # a batch already on the card: the first from the loader, whose
        # iterator is then dropped
        it = iter(loader)
        b = next(it)
        del it
        gc.collect()
        _check_no_loader_threads("a dropped DataLoader iterator")
        x, y = b[0].as_in_context(gpu), b[1].as_in_context(gpu)
        check(tuple(x.shape) == (batch, 3, DENSE["size"], DENSE["size"])
              and b[0].context == mx.cpu(), "the loader's batch is %s on %s"
              % (tuple(b[0].shape), b[0].context))
        torch.cuda.reset_peak_memory_stats()
        _zero_conv_counts(hc)
        t0 = time.perf_counter()
        losses.append(counted(x, y))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        n_params = sum(int(np.prod(p.shape))
                       for p in net.collect_params().values())
        times = timed_steps(lambda: counted(x, y), losses.append)
        step_ms = float(np.median(times)) * 1e3
        # one epoch through the loader
        waits = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = iter(loader)
        while True:
            tw = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                break
            waits.append(time.perf_counter() - tw)
            losses.append(counted(b[0].as_in_context(gpu),
                                  b[1].as_in_context(gpu)))
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        del it
        _check_no_loader_threads("the DataLoader's epoch")
        epoch_steps = len(waits)
        check(epoch_steps == DENSE["images"] // batch, "the epoch ran %d "
              "steps" % epoch_steps)
        launches = _conv_counts(hc)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for i, c in enumerate(per_step):
            got = {k: c[k] for k in want}
            check(got == want, "DenseNet-121 step %d launched %s of kernels "
                  "1 and 2, the plans say %s" % (i, got, want))
            check(c["taps_conv_bf16"] == 0 and c["taps_wgrad_bf16"] == 0,
                  "DenseNet-121 launched the bf16 kernels")
        losses = [_mean_loss(v) for v in losses]
        check(all(math.isfinite(v) for v in losses), "DenseNet-121's loss "
              "is not finite: %s" % losses)
        ips = batch / (step_ms / 1e3)
        epoch_ips = epoch_steps * batch / epoch_s
        wait_share = sum(waits) / epoch_s
        print("[densenet] DenseNet-121 (%d classes, %.2f M parameters), "
              "hybridized, fp32, batch %d x 3 x %d x %d, Trainer('nag', lr "
              "%g, momentum %g, wd %g) on %s" % (
                  DENSE["classes"], n_params / 1e6, batch, DENSE["size"],
                  DENSE["size"], DENSE["lr"], DENSE["momentum"], DENSE["wd"],
                  card))
        print("[densenet] a batch on the card: first step %.1f ms, %d timed "
              "steps median %.2f ms (min %.2f, max %.2f): %.1f images/s"
              % (first_s * 1e3, TIMED_STEPS, step_ms, min(times) * 1e3,
                 max(times) * 1e3, ips))
        print("[densenet] one epoch of the .rec (%d images written in %.1f "
              "s) through DataLoader(%d workers, RandomResizedCrop, mirror, "
              "ToTensor, Normalize): %d steps in %.2f s, %.1f images/s, "
              "%.1f%% of it waiting in next() (median wait %.2f ms, max "
              "%.2f); a step %.2f ms with the loader, %.2f without"
              % (DENSE["images"], write_s, DENSE["workers"], epoch_steps,
                 epoch_s, epoch_ips, 100 * wait_share,
                 float(np.median(waits)) * 1e3, max(waits) * 1e3,
                 epoch_s / epoch_steps * 1e3, step_ms))
        print("[densenet] kernels 1 and 2 a step (the plans'): %s, held "
              "each of %d steps; over the run: %s; peak %.2f GB"
              % (want, len(per_step), launches, peak_gb))
        profile = _dense_profile(card, lambda: step.step(x, y), step_ms,
                                 "densenet-profile", batch)
        # learning: 5 epochs of a 64-image subset, centred crops
        sub = DataLoader(
            ImageRecordDataset(rec).transform_first(_dense_pipeline(mx,
                                                                    False)),
            batch_sampler=BatchSampler(RandomSampler(DENSE["subset"]), batch,
                                       "discard"),
            num_workers=DENSE["workers"])
        epoch_means = []
        for _ in range(DENSE["epochs"]):
            vals = [step.step(b[0].as_in_context(gpu),
                              b[1].as_in_context(gpu)) for b in sub]
            epoch_means.append(float(np.mean([_mean_loss(v)
                                              for v in vals])))
        _check_no_loader_threads("the subset's DataLoader")
        print("[densenet] %d epochs of a %d-image subset (centred crops): "
              "epoch mean losses %s" % (DENSE["epochs"], DENSE["subset"],
                                        ", ".join("%.4f" % v
                                                  for v in epoch_means)))
        check(all(math.isfinite(v) for v in epoch_means)
              and epoch_means[-1] < epoch_means[0],
              "DenseNet-121's loss did not fall over the subset: %s"
              % epoch_means)
        reloads = _dense_reloads(mx, net, x[:DENSE["cpu_batch"]], tmp)
        del step, net, x, y, b, ds, loader, sub
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {
        "params": n_params, "step_launches": want, "steps": len(per_step),
        "first_step_ms": first_s * 1e3, "step_ms": step_ms,
        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
        "images_per_s": ips, "epoch_images_per_s": epoch_ips,
        "epoch_s": epoch_s, "epoch_step_ms": epoch_s / epoch_steps * 1e3,
        "wait_share": wait_share, "peak_gb": peak_gb,
        "losses": losses, "subset_epoch_means": epoch_means,
        "profile": profile, "cpu_check": cpu_check, "reloads": reloads}


def zoo_routed_convs(sym, shape):
    """(kernel-1 calls, their (M, C, O)) of one forward of ``sym`` on data
    of ``shape``: the convolutions the dispatch routes to kernel 1 (3x3 /
    pad 1 at stride 1, or 2 on even sides; one group)."""
    from mxnet_tpu_torch.ops.nn import hopper_conv_mode
    internals = sym.get_internals()
    _, shapes, _ = internals.infer_shape(data=shape)
    shape_of = {(id(n), i): s for (n, i), s in zip(internals._outputs,
                                                  shapes)}
    calls = []
    for node in sym._topo():
        if node.is_var or node.op.name != "Convolution":
            continue
        parent, idx = node.inputs[0]
        in_shape = shape if parent.is_var else shape_of[(id(parent), idx)]
        attrs = node.parsed_attrs()
        t = torch.empty(in_shape, device="meta")
        if hopper_conv_mode(attrs, t) in ("s1", "s2"):
            s = 1 if hopper_conv_mode(attrs, t) == "s1" else 2
            ho, wo = in_shape[2] // s, in_shape[3] // s
            calls.append((in_shape[0] * ho * wo, in_shape[1],
                          attrs["num_filter"]))
    return calls


def _zoo_score(mx, net, batch, size, warmup=3, iters=10):
    """``benchmark_score.py``'s ``score()`` on the port: images/s of
    ``iters`` hybridized forwards of a uniform batch after ``warmup``."""
    x = mx.nd.random.uniform(shape=(batch, 3, size, size), ctx=mx.gpu(0))
    for _ in range(warmup):
        net(x).wait_to_read()
    tic = time.time()
    for _ in range(iters):
        net(x).wait_to_read()
    return iters * batch / (time.time() - tic)


def phase_zoo(card):
    """The model zoo served through benchmark_score.py's loop (see the
    module docstring, phase 23); returns kernel 1's launches over the
    counted forwards and the phase's record."""
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import hopper_conv as hc
    fp32_exact()
    gpu = mx.gpu(0)
    sms = _sms(torch.device("cuda", 0))
    nets = [(n, 224, (1, 32)) for n in ZOO_DEFAULT] + \
        [(n, s, (32,)) for n, s in ZOO_MORE]
    total = dict.fromkeys(("implicit_gemm_conv",
                           "implicit_gemm_conv reduction", "taps_wgrad",
                           "taps_wgrad reduction"), 0)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
        for k, (name, size, batches) in enumerate(nets):
            with mx.name.NameManager():
                net = getattr(vision, name)()
            mx.random.seed(SEED + k)
            net.initialize(mx.init.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2),
                           ctx=gpu)
            net.hybridize()
            r = np.random.default_rng(SEED + k)
            x1 = r.uniform(size=(1, 3, size, size)).astype(np.float32)
            logits = net(mx.nd.array(x1, ctx=gpu)).asnumpy()
            path = os.path.join(tmp, name + ".params")
            net.save_parameters(path)
            with mx.name.NameManager():
                cnet = getattr(vision, name)()
            cnet.load_parameters(path, ctx=mx.cpu())
            cnet.hybridize()
            cpu_logits = cnet(mx.nd.array(x1, ctx=mx.cpu())).asnumpy()
            del cnet
            err = _rel_max(logits, cpu_logits)
            same_top1 = int(logits.argmax()) == int(cpu_logits.argmax())
            rec = {"size": size, "logit_rel_err": err,
                   "top1_equal": same_top1, "images_per_s": {},
                   "kernel1_per_forward": {}}
            for b in batches:
                calls = zoo_routed_convs(net._cached_graph[1],
                                         (b, 3, size, size))
                sums = sum(hc.conv_fp32_plan(M, C, O, 3, 3, sms).splits > 1
                           for M, C, O in calls)
                x = mx.nd.random.uniform(shape=(b, 3, size, size), ctx=gpu)
                before = _conv_counts(hc)
                net(x).wait_to_read()
                after = _conv_counts(hc)
                got = {kk: after[kk] - before[kk] for kk in total}
                for kk in total:
                    total[kk] += got[kk]
                check(got["implicit_gemm_conv"] == len(calls)
                      and got["implicit_gemm_conv reduction"] == sums
                      and got["taps_wgrad"] == 0,
                      "%s at batch %d launched %s of kernels 1 and 2, its "
                      "routed 3x3s %d with %d split sums"
                      % (name, b, got, len(calls), sums))
                rec["kernel1_per_forward"][b] = {"launches": len(calls),
                                                 "split_sums": sums}
                rec["images_per_s"][b] = _zoo_score(mx, net, b, size)
            n1 = rec["kernel1_per_forward"][batches[0]]["launches"]
            print("[zoo] %s (%d px): %s images/s; kernel 1 %d launches a "
                  "forward (%s split sums); batch-1 logits vs the CPU %.3g "
                  "of max |logit| (tol %g), top-1 %s on %s"
                  % (name, size, ", ".join(
                      "batch %d %.1f" % kv
                      for kv in rec["images_per_s"].items()), n1,
                     "/".join(str(v["split_sums"]) for v in
                              rec["kernel1_per_forward"].values()),
                     err, ZOO_TOL, "equal" if same_top1 else "DIFFERS",
                     card))
            check(err <= ZOO_TOL and same_top1, "%s's card logits differ "
                  "from the CPU's: %.3g, top-1 equal %s" % (name, err,
                                                           same_top1))
            if name in ZOO_KERNEL1:
                check(n1 > 0, "%s launched no kernel-1 call" % name)
            out[name] = rec
            del net
            gc.collect()
            torch.cuda.empty_cache()
    return total, out


def _ring_entries(k4, k10, launches):
    """Kernel 4's and 10's ``kernels`` entries: kernel 4's times summed over
    the main path's launches (a causal ring forward at sp 8: 28 full steps
    and 8 diagonal ones), kernel 10's for its one probe."""
    n = LONG["sp"]
    steps = {"full": n * (n - 1) // 2, "diag": n}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        k4[key] = sum(k4["per_call"][m][key] * c for m, c in steps.items())
    k4["bound_by"] = "operations" if all(
        t["bound_by"] == "operations" for t in k4["per_call"].values()) \
        else "bytes"
    k4["launches"] = launches["flash_attention_stats"]
    k4["calls_per_forward"] = steps
    k10["launches"] = launches["zero_fill"]
    return [k4, k10]


def _ring_bwd_sums(per_call, launches):
    """The fused backward on the ring's path: its per-call times at the
    full and diagonal steps, summed over a causal ring backward at sp 8 (28
    full steps, 8 diagonal), with the path's launches from phase 11."""
    n = LONG["sp"]
    steps = {"full": n * (n - 1) // 2, "diag": n}
    out = {"per_call": per_call, "calls_per_backward": steps,
           "launches": launches["flash_bwd"],
           "dq_sum_launches": launches["flash_dq_sum"]}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        out[key] = sum(per_call[m][key] * c for m, c in steps.items())
    return out


def _kernel_entries(fwd, wgrad, dgrad, launches, serving_launches):
    """The ``kernels`` line: times summed over one training step's calls
    at batch 32 (kernel 1: the 16 forwards and 16 dgrads; kernel 2: the 16
    wgrads, both passes), launches from the training run (kernel 2: its
    partial and reduction passes together, and each apart)."""
    by_shape = {(s["C"], s["H"]): s for s in fwd["shapes"]
                if s["class"] == "s1"}

    def step_sum(records, key, fwd_too=False):
        total = sum(r[key] * r["instances_per_step"] for r in records)
        if fwd_too:
            total += sum(by_shape[(C, H)][key] * count
                         for C, H, count in GLUON_3X3)
        return total

    k1 = {"name": "implicit_gemm_conv", "route": "cuda",
          "source": fwd["source"], "replaces": fwd["replaces"],
          "launches": (launches["implicit_gemm_conv"]
                       + launches["implicit_gemm_conv reduction"]),
          "conv_launches": launches["implicit_gemm_conv"],
          "reduce_launches": launches["implicit_gemm_conv reduction"],
          "max_abs_err": max([fwd["max_abs_err"]]
                             + [r["max_abs_err"] for r in dgrad])}
    k2 = {"name": "taps_wgrad", "route": "cuda",
          "source": "mxnet_tpu_torch/csrc/taps_wgrad.cu",
          "replaces": "mxnet_tpu/ops/pallas_conv.py:165",
          "launches": (launches["taps_wgrad"]
                       + launches["taps_wgrad reduction"]),
          "partial_launches": launches["taps_wgrad"],
          "reduce_launches": launches["taps_wgrad reduction"],
          "max_abs_err": max(r["max_abs_err"] for r in wgrad)}
    for entry, records, fwd_too in ((k1, dgrad, True), (k2, wgrad, False)):
        for key in ("ms", "plain_ms", "bound_ms"):
            entry[key] = step_sum(records, key, fwd_too)
        entry["bound_by"] = "operations" if all(
            r["bound_by"] == "operations" for r in records) else "bytes"
        entry["library_ms"] = step_sum(records, "library_ms", fwd_too)
    k2["tflops"] = _step_sum(wgrad)["tflops"]
    k1["dgrad_shapes"] = dgrad
    k1["serving_forward"] = {"launches": serving_launches, **{
        k: fwd[k] for k in ("ms", "plain_ms", "bound_ms",
                            "library_ms", "tflops_per_forward", "occupancy",
                            "ragged_errs", "shapes")}}
    k2["shapes"] = wgrad
    return [k1, k2]


def _bf16_entries(k1, k2, bf16_kernels, launches):
    """Kernel 12's ``kernels`` entry and those of kernels 1 and 2's bf16
    kernels (``taps_conv_bf16.cu``, ``taps_wgrad_bf16.cu``), named again
    under kernels 1 and 2's ``bf16`` keys: times summed over the calls of
    one batch-128 bf16 training step (kernel 12: its 36 1x1 wgrads; kernel
    2: the 16 3x3 wgrads; kernel 1: the 16 forwards and 16 dgrads), launches
    from phase 14's run."""
    w1x1, wgrad, fwd, dgrad, ragged = bf16_kernels

    def step_sum(records, key):
        return sum(r[key] * r["instances_per_step"] for r in records)

    def bound_by(records):
        return "operations" if all(r["bound_by"] == "operations"
                                   for r in records) else "bytes"

    k12 = {"name": "conv1x1_wgrad", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/conv1x1_wgrad.cu",
           "replaces": "tools/probe_conv_fixes.py:173",
           "launches": (launches["conv1x1_wgrad"]
                        + launches["conv1x1_wgrad reduction"]),
           "partial_launches": launches["conv1x1_wgrad"],
           "reduce_launches": launches["conv1x1_wgrad reduction"],
           "max_abs_err": max(r["max_abs_err"] for r in w1x1),
           "max_rel_err": max(r["max_rel_err"] for r in w1x1)}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        k12[key] = step_sum(w1x1, key)
    k12["bound_by"] = bound_by(w1x1)
    k12["shapes"] = w1x1
    k1b = {"name": "taps_conv_bf16", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/taps_conv_bf16.cu",
           "replaces": "mxnet_tpu/ops/pallas_conv.py:152",
           "launches": launches["taps_conv_bf16"],
           "max_abs_err": max(r["max_abs_err"] for r in fwd + dgrad),
           "bound_by": bound_by(fwd + dgrad),
           "forward_shapes": fwd, "dgrad_shapes": dgrad}
    k2b = {"name": "taps_wgrad_bf16", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/taps_wgrad_bf16.cu",
           "replaces": "mxnet_tpu/ops/pallas_conv.py:165",
           "launches": (launches["taps_wgrad_bf16"]
                        + launches["taps_wgrad_bf16 reduction"]),
           "partial_launches": launches["taps_wgrad_bf16"],
           "reduce_launches": launches["taps_wgrad_bf16 reduction"],
           "max_abs_err": max(r["max_abs_err"] for r in wgrad),
           "max_rel_err": max(r["max_rel_err"] for r in wgrad),
           "bound_by": bound_by(wgrad), "shapes": wgrad}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        k1b[key] = step_sum(fwd, key) + step_sum(dgrad, key)
        k2b[key] = step_sum(wgrad, key)
    for entry, records, prefix in ((k1b, fwd + dgrad, "k1 "),
                                   (k2b, wgrad, "k2 "), (k12, w1x1, "k12 ")):
        entry["tflops"] = step_sum(records, "gflop") / entry["ms"]
        entry["ragged_errs"] = {k: v for k, v in ragged.items()
                                if k.startswith(prefix)}
    for entry, base in ((k1b, k1), (k2b, k2)):
        base["bf16"] = {key: entry[key] for key in (
            "name", "source", "launches", "ms", "tflops",
            "bound_ms", "library_ms")}
    return k12, k1b, k2b


def _block_entry(records, launches):
    """Kernel 13's ``kernels`` entry: times summed over one batch-128 bf16
    ResNet-50 forward's 12 blocks, launches from phase 16's predict and
    score."""
    fwd = [r for r in records if r["instances_per_forward"]]
    k13 = {"name": "fused_bottleneck", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/fused_bottleneck.cu",
           "replaces": "tools/probe_fused_block.py:74",
           "launches": launches["fused_bottleneck"],
           "max_abs_err": max(r["max_abs_err"] for r in records),
           "bound_by": "operations" if all(
               r["bound_by"] == "operations" for r in fwd) else "bytes",
           "shapes": records}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        k13[key] = sum(r[key] * r["instances_per_forward"] for r in fwd)
    return k13


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import mxnet_tpu_torch  # noqa: F401  (fails outside the repository)
    card = card_line()
    print("[device] %s | %s | torch %s, CUDA %s" % (
        torch.cuda.get_device_name(0), card, torch.__version__,
        torch.version.cuda))
    t0 = time.perf_counter()
    phase_build()
    fwd = phase_kernels()
    wgrad, wgrad128, dgrad, wgrad_ragged = phase_backward_kernels()
    lstm = phase_lstm_kernels()
    attn = phase_attn_kernels(card)
    k4, k10, ring_bwd = phase_ring_kernels(card)
    k11 = phase_rtc(card)
    bf16_kernels = phase_bf16_kernels()
    block_kernels, block_forced = phase_fused_block_kernels()
    fcn_kernels = phase_fcn_kernels()
    dense_kernels, dense_misaligned = phase_densenet_kernels()
    serving_launches, served = phase_serving(card)
    served["profile"] = phase_profile(card)
    print("[serving] summary " + json.dumps(dict(served, card=card)))
    launches, trained, (ft, x, y) = phase_training(card)
    trained["profile"] = phase_training_profile(
        card, lambda: ft.step(x, y), trained["step_ms"])
    del ft, x, y
    print("[training] summary " + json.dumps(dict(trained, card=card)))
    fp32_ips = trained["images_per_s"]
    lm_launches, lm, trainer = phase_lm_training(card)
    lm["profile"] = phase_lm_profile(card, trainer, lm["step_ms"])
    del trainer
    lm["cpu_check"] = phase_lm_vs_cpu(card)
    print("[lm-training] summary " + json.dumps(dict(lm, card=card)))
    for k in lstm:
        k["launches"] = lm_launches[k["name"]]
    tfm_launches, tfm, trained = phase_tfm_training(card)
    tfm["profile"] = phase_tfm_profile(card, trained, tfm["step_ms"])
    del trained
    tfm["cpu_check"] = phase_tfm_vs_cpu(card)
    print("[tfm-training] summary " + json.dumps(dict(tfm, card=card)))
    for k in attn:
        k["launches"] = tfm_launches[_COUNTER_OF.get(k["name"], k["name"])]
        if k["name"] in _COUNTER_OF:
            k["dq_sum_launches"] = tfm_launches["flash_dq_sum"]
    ring_launches, ring = phase_long_context(card)
    for k in attn:
        if k["name"] in ring["kernel_checks"]:
            k["long_context_err"] = ring["kernel_checks"][k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], k["long_context_err"])
    print("[long-context] summary " + json.dumps(dict(ring, card=card)))
    for k in attn:
        if k["name"] in _COUNTER_OF:
            k["ring"] = _ring_bwd_sums(ring_bwd, ring_launches)
    composed = phase_compositions(card)
    print("[compositions] summary " + json.dumps(dict(composed, card=card)))
    mod_launches, moduled = phase_module(card)
    print("[module] summary " + json.dumps(dict(moduled, card=card)))
    bf16_launches, bf16_trained = phase_bf16_training(card, fp32_ips)
    print("[bf16-training] summary "
          + json.dumps(dict(bf16_trained, card=card)))
    bf16_moduled, mod16 = phase_bf16_module(card)
    print("[bf16-module] summary " + json.dumps(dict(bf16_moduled,
                                                     card=card)))
    infer_launches, inferred = phase_bf16_inference(card, mod16)
    del mod16
    print("[bf16-infer] summary " + json.dumps(dict(inferred, card=card)))
    bucket_launches, bucketed = phase_bucketing(card)
    print("[bucketing] summary " + json.dumps(dict(bucketed, card=card)))
    imgrec_launches, imgrec = phase_imgrec(card, moduled["images_per_s"])
    print("[imgrec] summary " + json.dumps(dict(imgrec, card=card)))
    eager_conv, eager_conv_nohyb, eager_lstm, eager = phase_eager(
        card, fp32_ips, lm["tokens_per_s"])
    print("[eager] summary " + json.dumps(dict(eager, card=card)))
    new_ops = phase_new_ops(card)
    print("[new-ops] summary " + json.dumps(dict(new_ops, card=card)))
    fcn_launches, fcn = phase_fcn(card)
    print("[fcn] summary " + json.dumps(dict(fcn, card=card)))
    dense_launches, dense = phase_densenet(card)
    print("[densenet] summary " + json.dumps(dict(dense, card=card)))
    zoo_launches, zoo = phase_zoo(card)
    print("[zoo] summary " + json.dumps(dict(zoo, card=card)))
    for k in lstm:
        k["lm_launches"] = k["launches"]
        k["bucketing_launches"] = bucket_launches[k["name"]]
        k["launches"] += bucket_launches[k["name"]]
    print("[done] all phases passed in %.1f s" % (time.perf_counter() - t0))
    k1, k2 = _kernel_entries(fwd, wgrad, dgrad, launches, serving_launches)
    k2["batch128"] = dict(_step_sum(wgrad128), shapes=wgrad128)
    k2["ragged_errs"] = wgrad_ragged
    k1["module_launches"] = (mod_launches["implicit_gemm_conv"]
                             + mod_launches["implicit_gemm_conv reduction"])
    k2["module_launches"] = (mod_launches["taps_wgrad"]
                             + mod_launches["taps_wgrad reduction"])
    k1["imgrec_launches"] = (imgrec_launches["implicit_gemm_conv"]
                             + imgrec_launches["implicit_gemm_conv reduction"])
    k2["imgrec_launches"] = (imgrec_launches["taps_wgrad"]
                             + imgrec_launches["taps_wgrad reduction"])
    for k, pre in ((k1, "implicit_gemm_conv"), (k2, "taps_wgrad")):
        k["eager_launches"] = (eager_conv[pre]
                               + eager_conv[pre + " reduction"])
        k["eager_unhybridized_launches"] = (
            eager_conv_nohyb[pre] + eager_conv_nohyb[pre + " reduction"])
    for k in lstm:
        k["eager_launches"] = eager_lstm[k["name"]]
    fcn_sums = fcn_kernel_sums(fcn_kernels)
    for k, pre, key in ((k1, "implicit_gemm_conv", "k1"),
                        (k2, "taps_wgrad", "k2")):
        k["fcn_launches"] = fcn_launches[pre] + fcn_launches[
            pre + " reduction"]
        check(fcn_launches[pre] > 0, "%s was not launched on the FCN-8s "
              "path" % pre)
        k["fcn"] = dict(fcn_sums[key], launches=k["fcn_launches"],
                        shapes=fcn_kernels)
        k["max_abs_err"] = max(k["max_abs_err"], fcn_sums[key]["max_abs_err"])
    dense_sums = fcn_kernel_sums(dense_kernels)
    for k, pre, key in ((k1, "implicit_gemm_conv", "k1"),
                        (k2, "taps_wgrad", "k2")):
        k["densenet_launches"] = dense_launches[pre] + dense_launches[
            pre + " reduction"]
        k["zoo_launches"] = zoo_launches[pre] + zoo_launches[
            pre + " reduction"]
        k["densenet"] = dict(dense_sums[key], launches=k["densenet_launches"],
                             shapes=dense_kernels,
                             misaligned=dense_misaligned)
        errs = [k["max_abs_err"], dense_sums[key]["max_abs_err"]]
        if key == "k1":
            errs += [v for n, v in dense_misaligned.items()
                     if not n.startswith("wgrad")]
        k["max_abs_err"] = max(errs)
    check(dense_launches["implicit_gemm_conv"] > 0
          and dense_launches["taps_wgrad"] > 0,
          "kernels 1 and 2 were not launched on the DenseNet-121 path")
    k12, k1b, k2b = _bf16_entries(k1, k2, bf16_kernels, bf16_launches)
    k13 = _block_entry(block_kernels, infer_launches)
    k13["forced_arms"] = block_forced
    k1b["bf16_inference_launches"] = infer_launches["taps_conv_bf16"]
    k1b["module_launches"] = bf16_moduled["bf16"]["conv_launches"][
        "taps_conv_bf16"]
    k2b["module_launches"] = (
        bf16_moduled["bf16"]["conv_launches"]["taps_wgrad_bf16"]
        + bf16_moduled["bf16"]["conv_launches"]["taps_wgrad_bf16 reduction"])
    print(json.dumps({"kernels": [k1, k2] + lstm + attn
                      + _ring_entries(k4, k10, ring_launches)
                      + [k11, k12, k13, k1b, k2b]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
