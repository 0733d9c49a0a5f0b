#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the run (non-zero exit, no result line) when it
does not hold:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``isegprobe_torch/csrc`` (A attention, B
   LayerNorm, C EDT row envelope, D cross-attention, E JBU filter, F and G
   attention variants, H int8 row quantizer and I int8 GEMM with its
   dequantizing epilogue; A, D, F and G on the flash core
   ``csrc/flash_core.cuh``) with nvcc, one process per source, all started
   together, print the ptxas report and, on a line of its own, the count of
   its C7515 lines (wgmma serialized by ptxas); read kernel E's tiling,
   resident blocks an SM, registers and local bytes from its library and
   its ptxas entry from this run's build (a spill, or fewer than the two
   blocks an SM of its design, fails the run), and kernel C's layout at the
   loop's row width (rows a block, threads, segment width, shared bytes,
   blocks an SM, registers, local bytes: any local byte fails the run);
3. hold kernels A and B against their plain PyTorch versions on the card, at
   the flagship shapes in f32 and bf16, at the device loop's batch of 16
   crops, and at attention shapes with dh != 64 (A also at dh = 13, whose
   bf16 rows take the element-load path), and time kernel, plain version
   and the one PyTorch call that computes the same function (a yardstick
   only: the port never calls it). A is checked and timed at the plan
   ``ops/attention.py:_plan`` picks (recorded) and, forced through the
   entry's ``plan``, at every other query tile and load path;
4. hold kernel C bitwise against its plain version (max abs error exactly 0)
   at the device loop's shape [8, 2, 514, 642] on the three inputs of
   ``bench_edt.py`` (random masks with zero-free columns, the clicker's
   error maps, one zero a column), timed; on random masks at 64x64 and at
   a width that is no multiple of 32; and over the rest of its domain
   (``bench_edt.domain_inputs``: W = 4096, W = 1, sentinel rows, single
   sources, column passes of height 5000, where g > 4096, and 40,000, where
   G > 2^30 and C takes its int64 path);
5. build the full-width flagship probe (DINOv2-S/14, 448², weights drawn
   from a seed, classifier bias set so that masks answer clicks), run
   one f32 forward on the card and the same forward on the CPU (plain
   versions), compare the logits, and check that one forward launches 12
   attention and 25 LayerNorm kernels;
6. main path 1, the host protocol: the Predictor answers NoC clicks
   (fixed-448 ZoomIn, flip TTA, f32) on two numpy-drawn scenes, with every
   launch counter set to 0 just before and read just after; prints the p50
   ms per click. Then one bf16 forward (params cast as evaluate.py casts
   them) is timed: exact launches, and its logits within 0.05 of the f32
   logits' scale;
7. the on-device clicker (``next_click_from_error``, kernel C underneath)
   on 32 random lanes must click exactly where the host scipy ``Clicker``
   clicks;
8. main path 2, the batched on-device NoC loop (``make_device_evaluator`` +
   ``evaluate_dataset_device``) on ten 480x640 scenes at B=8 (a padded
   tail chunk), 20 clicks, f32, with a target IoU picked from a first run
   so that lanes stop at different clicks. Counters set to 0 just before
   and read just after: every loop step launches exactly 1 C, 12 A and 25
   B. The B=8 trajectories must equal the B=1 ones, and two of them the
   host Predictor's;
9. one whole device-loop evaluation under
   ``torch.cuda.set_sync_debug_mode("error")``, lifted only around the one
   allowed read per click: any other synchronising op fails the run;
10. the trunk cache at full width (``after_backbone`` flagship, B=4, 5
    clicks): cached trajectories equal uncached ones, and the trunk was
    recomputed on some clicks but not all;
11. throughput of the device loop (f32 B=8, bf16 B=8 and B=16 on sixteen
    scenes) beside the host protocol's p50 per click, and the split of one
    f32 B=8 loop step (clicker, crop, forward at batch 16, paste; kernel C
    on the step's own error maps, bitwise against its plain version);
11b. the trained probes (main paths 8-13): the 160-epoch flagship
    checkpoint loaded through ``isegprobe_torch.evaluate.
    load_model_for_eval`` (frozen backbone rebuilt from PRNGKey(0) in numpy:
    its seconds and 22,056,192 parameters printed; a later load or trainer
    of the same backbone and upsampler config reuses the frozen parts
    through ``load_model_for_eval(frozen=...)``) and held against the
    JAX package's results stored in ``isegprobe_torch/fixtures/
    synthetic2026_50.npz`` (the Synthetic scenes, 78 objects): the f32
    device loop at B=8 on every object (IoUs within 1e-3 of JAX's up to an
    object's first click that differs, at most 2 objects differing, each
    printed; NoC@80/85/90 within 0.05; every step 1 C, 12 A and 25 B), the
    f32 host protocol on the first 8 objects (checked the same way; p50 ms
    per click and per get_prediction), the bf16 loops at B=8 and B=16 (NoC
    within 0.04 of JAX's f32 NoC, lane-clicks/s beside f32's); then the
    448² LoftUp
    checkpoint (its missing upsampler_path must warn) through the f32 loop
    on the fixture's 2 objects and 4 clicks against JAX's, with no object
    differing (every step 1 C, 12 A, 82 B and 14 D), and timed on the first
    4 objects at the family loop's 4 lanes and 6 clicks (a report, every
    step launching the same). Kernels A, B, C and D are also checked at these
    paths' shapes: A and B in bf16 at the B=16 loop's forward batch 32, B
    at LoftUp's widths (404 on the slab and key rows, 203 on the stem, 384
    in the ChannelNorm) at both LoftUp loops' forward batches, C on 258²
    rows, D at forward batch 4;
11c. training (main paths 14-16, ``isegprobe_torch/train.py``): kernels A
    and B under autograd at the train step's shapes ([8, 257, 1152] and
    [8, 257, 384], f32: the forward with grad equal to the no-grad kernel
    bitwise with one launch, the gradients equal to autograd through the
    plain version; forward + backward timed beside the plain version's;
    B's backward kernel also against its plain version ``_ln_plain_bwd``,
    one launch for dx alone and two with dweight and dbias, bitwise over
    two runs, graph-timed beside its bound and
    ``aten.native_layer_norm_backward``; every step 25 B backward
    launches),
    A, B and C forward-checked at those shapes; the Synthetic training
    items built without OpenCV from the seeds of ``isegprobe_torch/
    fixtures/synthetic_train_step.npz`` against its JAX items (masks and
    points equal, images within 1 grey level on 0.1% of pixels; the count
    of exact items printed); the full-width step from ``init_tree(config,
    0)`` on that batch at num_iters=0, twice: losses within 1e-5 of JAX's
    and every trainable leaf's sum, L2 norm and first 16 values within
    tolerance of JAX's, with a profiler split of one step; an epoch of
    96 items (12 steps at B=8, 0-3 simulated clicks; the command line's
    epoch is 320 items, cut to make room for phases 11f and 11g) with
    validation
    through the command line's trainer: every step launching exactly
    (1 + num_iters) × (12 A + 25 B) + num_iters C, median ms a step, data
    wait, the first and last 10 steps' mean loss, and the checkpoint read
    back by ``load_model_for_eval`` giving the trainer's logits within
    1e-5 of their scale;
11d. the other backbones the paper probes (main paths 17-28,
    ``isegprobe_torch.models.probe_model.synthetic_config``): kernels A and
    B checked and timed at their shapes (A at [16, 785, 2304] in f32 and
    bf16, [16, 1024, 1536] in f32 and bf16, [16, 785, 1152]; B at
    [16, 785, 768] eps 1e-5, [16, 785, 384], [16, 1024, 588] and
    [16, 1024, 384]); the trained MaskCLIP checkpoint through
    ``load_model_for_eval`` (81,468,672 frozen parameters of the CLIP
    tower rebuilt from PRNGKey(0)) held against the JAX package's results
    in ``isegprobe_torch/fixtures/synthetic_maskclip.npz`` as the
    flagship's are in 11b (f32 loop at B=8 on the exported objects, host
    protocol on the first 8, every step 1 C, 11 A and 25 B), its bf16
    loops at B=8 and 16 (NoC within 0.1 of JAX's f32 NoC), and a timed f32
    loop on all 78 objects when fewer were exported; then the drawn DINO
    ViT-S/16 key probe (11 A + 23 B a forward), DINOv2 + SimpleViT late
    injection (18 A + 40 B a forward; in the loop the trunk cache runs the
    SimpleViT's 6 A + 15 B a step and the trunk's 12 A + 25 B on each
    chunk's first click and each recompute, trajectories equal to the
    uncached loop's) and DINOv2 + LiFT (12 A + 25 B) at 448²: each a forward
    against the CPU and a loop of 4 lanes and 5 clicks on the drawn
    scenes with exact launches, and the linear and simple_conv heads on
    the key probe, a forward each;
11e. ritm_and_refill, the RITM adaptive protocol and continuous batching
    (main paths 29-36) on the trained flagship, loaded as ``eval_ritm``
    loads it, over the 78 stored objects (20 clicks, target IoU 0.9):
    (a) the adaptive f32 device loop at B=8 held against the JAX package's
    adaptive results in ``isegprobe_torch/fixtures/synthetic_ritm.npz`` as
    11b holds the fixed loop (IoUs within 1e-3 up to the first differing
    click, at most 2 objects differing, NoC within 0.05; every step 1 C and
    25 B, its attention the plain masked path); (b) the adaptive bf16 loop
    at B=8 (NoC within 0.1 of JAX's f32); (c) the host transform chain on
    the first 8 objects held against JAX's host chain in the fixture as
    11b holds the host protocol (every click one true-size forward, 12 A +
    25 B), and its gap to (a) reported (the chain averages the flip's
    probabilities, the loop its logits: JAX's own pair parts by 0.0201 in
    IoU on these objects); (d) the fixed-crop loop through
    the job queue (``evaluate_dataset_group``) at B=8 f32 and B=16 bf16
    beside 11b's lockstep loops (same models, batches and protocol): f32
    click counts and clicks equal to lockstep's, IoUs
    within 1e-4, NoC equal to the fixture's; (e) the adaptive loop through
    the queue at B=8 f32 clicking as (a); (f) each loop's ms a step,
    lane-clicks/s, useful clicks, lane-steps and clicking share, lockstep
    beside refill; a profiler split of the masked forward at forward batch
    16; the plain masked attention timed at [16, 842, 1152] f32 beside
    kernel A at that shape; B at [16, 842, 384] f32 and bf16 and C at the
    adaptive loop's [8, 2, 258, 258] against their plain versions; (g) the
    drawn SimpleViT probe (late injection, trunk cache) through the queue
    on 4 lanes, 7 jobs, clicking as its lockstep loop, with the refilled
    lanes' poisoned trunk recomputed (launches: the click encoder's 6 A +
    15 B a step, the trunk's 12 A + 25 B a recompute, 1 C a step);
11f. family_training, training the other Synthetic probes (main paths
    37-51, ``python -m isegprobe_torch.train model=synthetic_<script>``
    for every script of ``models/synthetic/``): (a) kernels D and E under
    autograd at the 224² train step's shapes (D: q [8, 50176, 4, 101]
    against k, v [8, 256, 4, 101]; E: hr [8, 2^k·16, 2^k·16, 384] at the
    four JBU stages), and B with its backward kernel at LoftUp's padded
    rows at 448² ([4, 28672, 512] real 404, [4, 68, 448, 256] real 203)
    and SimpleViT's [16, 1024, 588] (as 11c): the forward with grad equal
    to the no-grad kernel bitwise with one launch, every input's gradient
    within 1e-5 of its scale of autograd through the plain version,
    forward + backward timed beside the plain version's (and SDPA's for
    D) with the peak memory of each; (b) the full-width LoftUp and JBU steps from ``init_tree(config,
    0)`` on the first items of the train-step fixture at num_iters=0,
    twice, against the JAX steps in ``isegprobe_torch/fixtures/
    synthetic_train_step_families.npz`` (losses within 1e-5 relative,
    leaves within 11c's tolerances, exactly 2 × (12 A + 34 B + 2 D) or
    2 × (12 A + 25 B + 4 E) launches, the click encoder's gradient
    non-zero), with ms a step, peak memory and a profiler split of a step
    with 2 clicks; (c) two steps of each through the command line's
    trainer with 0-3 clicks and two validation steps, every step
    launching exactly (1 + num_iters) × its forward's kernels + num_iters
    C, and the checkpoint read back by ``load_model_for_eval`` at 518²
    within 1e-5 of the logit scale; (d) one LoftUp step at 448², batch 8,
    its 7 slabs of 64 rows checkpointed: 12 A + 82 B + 14 D forward and
    56 B + 14 D recomputed in the backward, peak memory printed; (e) two
    command-line steps each of ``vit_noup``, ``maskclip_noup``,
    ``dinov2_simplevit`` and ``dinov2_lift``, launches checked as in (c),
    the checkpoints read back (DINOv2 at 518², the DINO probe and
    MaskCLIP at 224²);
11g. bf16_training, mixed-precision training (main paths 52-66,
    ``python -m isegprobe_torch.train training_params.dtype=bfloat16``):
    (a) kernels A, B, D and E under autograd in bf16 at the 224² train
    steps' shapes (A [8, 257, 1152], B [8, 257, 384] with float32 weight
    and bias, D q [8, 50176, 4, 101] against [8, 256, 4, 101], E hr
    [8, 2^k·16, 2^k·16, 384]): the forward bitwise to the no-grad kernel
    with one launch and within the bf16 tolerance of the plain version,
    every gradient in its input's dtype and within 2^-8 of the scale of
    autograd through the plain version, forward + backward timed beside
    the plain version's and the library's (SDPA, ``F.layer_norm``), with
    peak memory; (b) the full-width bf16 flagship and LoftUp steps from
    ``init_tree(config, 0)`` on the train-step fixture's 8 items at
    num_iters=0, twice, against the JAX bf16 steps in ``isegprobe_torch/
    fixtures/synthetic_train_step_bf16.npz`` (losses within 2^-10
    relative, leaves within 11c's tolerances with 64 sign flips), and the
    JBU bf16 step alone (the JAX package cannot train JBU in bf16), each
    with ms a step, peak memory and the device-busy share of a profiled
    step at 0 and 2 clicks; (c) two bf16 command-line steps of LoftUp and
    JBU with clicks and validation, launches checked as in 11f, the
    checkpoint float32 with no dtype in its config;
    (d) the bf16 flagship and LoftUp steps at 448², batch 8, with and
    without ``training_params.remat_backbone`` (remat launches each
    block's A and 2 B again in the backward: 12 A + 24 B), ms and peak
    memory; (e) four bf16 command-line steps of the flagship (the float32
    checkpoint read back at 518² within 1e-5 of the logit scale), then the
    same run resumed (``training.resume_exp=0``): its leaves loaded
    bitwise, then moved; (f) a bf16 step with two simulated clicks whose
    first runs a ``click_models`` tree (another head; the frozen tensors
    shared): 3 × (12 A + 25 B) + 2 C;
11h. data, the paper's data (main paths 67-76: ``data/image_io.py``,
    ``data/datasets/standard.py``, ``python -m isegprobe_torch.train
    model=sbd_*``, ``python -m isegprobe_torch.evaluate datasets=...``) on
    the trees of ``isegprobe_torch/fixtures/datasets/``, against
    ``isegprobe_torch/fixtures/datasets.npz``: (a) every file decoded
    without OpenCV to ``cv2.imread``'s pixels (sha256), ms per SBD-size
    JPEG; (b) the SBD train and val items from 4 loader threads and the
    train items from 4 spawned processes (``dataloader.mp``) equal to the
    JAX package's (sha256), ms an item for each; (c) the full-width 224²
    steps of ``sbd_dinov2_noup`` and ``sbd_dinov2_bilinear`` at batch 8 on
    those items at num_iters=0, twice: 2 × (12 A + 25 B), losses within
    1e-5 of JAX's, leaves as 11c's; then two command-line steps of each
    (threads for the first, processes for the second) with clicks and
    validation, launches as 11c's, data wait a step, the checkpoint read
    back at 518²; (d) the trained flagship through the evaluate CLI's
    ``evaluate`` on GrabCut, Berkeley, DAVIS, SBD and PascalVOC (fixed
    448², at most 20 clicks, target IoU 0.9), f32: the device loop through the
    job queue at B=8 on every object (every step 1 C + 12 A + 25 B) and
    the host protocol on each dataset's first object, held to the JAX
    trajectories as 11b's loops are (IoUs within 1e-3 up to the first
    differing click, at most 2 objects of a dataset differing, NoC within
    0.05), ms a loop step and a host click;
11i. brs, the rest of the host protocol (main paths 77-83:
    ``ops/edt.py`` on ``csrc/host/edt.cpp``, ``inference/brs.py``,
    ``python -m isegprobe_torch.evaluate mode=...``, ``CropsPredictor``,
    ``click_models``), against ``isegprobe_torch/fixtures/
    synthetic_brs.npz`` (the JAX package's BRS results for the trained
    flagship at 448², f32): (a) the native host EDT bitwise against its
    scipy plain version on the clicker's inputs of the five trees, ms an
    EDT for both at 480x640 and 854x480, the host click p50 on the first
    DAVIS and GrabCut objects and ms an SBD item from 4 threads; (b) the
    f-BRS-B, RGB-BRS and DistMap-BRS objectives at x = 0 and a seeded x
    on the first object after two clicks (the fixture's predictor states):
    value within 1e-5 relative and gradient within 1e-4 of its largest
    magnitude of JAX's, ms an evaluation and its ``torch.profiler``
    split, B's backward launches an evaluation (non-zero in Input-BRS);
    (c, d) ``evaluate(...)`` with
    ``mode=f-BRS-B`` on the first 8 objects (20 clicks, target 0.9),
    DistMap-BRS on 2 × 5 and RGB-BRS on 1 × 3 (with ``device_loop=true``,
    which runs the host protocol and says so): IoUs within 1e-3 up to an
    object's first click where the L-BFGS evaluation counts, early stops
    or clicks part from JAX's, at most 2 of 8 parting, each printed with
    its cause; NoC against JAX's, evaluations a click, ms a click and an
    optimized click; every click's launches exact (f-BRS: 12 A + 25 B, the
    trunk; Input-BRS: an evaluation's 12 A + 25 B each, one forward on a
    click without L-BFGS); (e) one f-BRS-B click (``maxfun`` 3) on drawn
    LoftUp and JBU probes at 448²: D or E under autograd, the objective
    within 1e-4 of the same objective with the plain version swapped in;
    (f) ``CropsPredictor`` (320x480 tiles) on DAVIS' 854x480 frames
    against ``TransformChainPredictor([Crops, SigmoidForPred,
    AddHorizontalFlip])``, which averages the flip's logits as it does
    (clicks equal, IoUs within 1e-3), beside ``[Crops, AddHorizontalFlip,
    SigmoidForPred]``, which averages probabilities (reported), and the
    ensemble
    ``click_models=[80ep, 160ep]`` on the first 8 objects against JAX's
    trajectories as 11b's host protocol; (g) A, B, D and E under autograd
    at the batch-1 shapes of these paths (A [1, 1025, 1152], B [1, 1025,
    384], D q [1, 28672, 4, 101] against [1, 1024, 4, 101], E [1, 512,
    512, 384]) as 11c's, with SDPA's and ``F.layer_norm``'s forward +
    backward;
11j. converted_weights, published weights (main paths 84-88:
    ``python -m isegprobe_torch.scripts.convert_reference_checkpoint`` and
    ``convert_weights``, ``PRETRAINED_MODELS`` in the trainer, LoftUp's
    padded layout and fused head, raw upsampler files through
    ``upsampler_path``, the CLIP text tower), against
    ``isegprobe_torch/fixtures/converted_weights.npz``: (a) the trained
    flagship written in the reference's torch layout (``@serialize``
    wrappers), converted (params bitwise) and evaluated through the
    evaluate CLI's ``parse_args`` / ``evaluate`` (device loop, B=8, f32, 78
    objects, every step 1 C + 12 A + 25 B): trajectories equal to the
    unconverted checkpoint's and NoC 3.2821 / 3.4615 / 4.3590, JAX's; (b)
    the flagship's frozen backbone (``init_tree`` at PRNGKey(0)) in the
    hub's layout, plain and in ``block_chunks``, converted back bitwise,
    two train steps through ``PRETRAINED_MODELS.DINOV2_VITS14`` with
    losses bitwise the steps' without it, and a drawn DINOv2-S/14's first
    loss within 5.9e-6 of JAX's; (c) the trained LoftUp at 448², B=4:
    padded against unpadded f32 logits within 1e-5 of their scale, forward
    ms of both layouts in f32 and bf16 (12 A + 82 B + 14 D each), the bf16
    loops (``mxu_pad`` auto, which pads, and off) on the fixture's 2
    objects × 4 clicks with NoC within 0.1 of JAX's f32, partings
    reported; (d) ``fuse_hr_head``: f32 logits within 1e-5 of the unfused
    ones, the same clicks, ms, and the forward's peak memory above the
    resident model below half the unfused one's; (e) drawn DINO-S/16, CLIP ViT-B/16 (fp16,
    visual and text towers), LiFT (``module.``) and raw LoftUp files
    converted by ``--kind`` or read through ``upsampler_path``, their
    outputs against JAX's samples (the text tower's ids from a merges file
    the phase writes, equal to JAX's), with exact launches; A, B and D
    against their plain versions at these paths' shapes (D at the padded
    dh 128 and B over 404 of 512 and 203 of 256 channels, f32 and bf16,
    with SDPA's time beside D);
11k. run_outputs, a researcher's outputs (main paths 89-91: what
    ``evaluate ... vis_preds save_feats save_ious iou_analysis`` and
    ``train ... image_dump_interval`` leave behind), against
    ``isegprobe_torch/fixtures/eval_outputs.npz``: (a) the evaluate CLI
    with every output key on the GrabCut, Berkeley and DAVIS trees (the
    trained flagship, f32, 448², 20 clicks an object, the host protocol:
    each click a prediction and a feature probe, 2 × (12 A + 25 B)), its
    files equal to the root CLI's set, its trajectories cut at IoU 0.9
    held against ``fixtures/datasets.npz`` as 11h holds them, each JSON
    IoU the pickle's × 100; the feature dumps (~308 MB a HighRes map at
    448²) removed after; ms a host click with ``vis_preds`` off, on and
    off; (b) the first-click feature probe of the trained flagship (f32
    and bf16) and LoftUp (f32) on 2 Synthetic objects: exact launches
    (12 A + 25 B; LoftUp 12 A + 82 B + 14 D), within 1e-4 (bf16 0.05) of
    the plain-version forward's scale on the card and within 1e-3 (bf16
    0.05) of JAX's samples, ms a call; (c) two epochs of 12 steps of the
    flagship's train CLI at 224², batch 8, three times without dumps and
    writer and three times with image dumps every 4 steps, interleaved:
    ``train.log``, the script's copy and the dumps in the run directory,
    the events' tags and steps (JAX's); the best of the three runs' median
    ms of the steps that neither dump nor follow a dump, with dumps, at
    most 1.25 × the best without (every run draws the same clicks); one
    more run each under ``set_sync_debug_mode("warn")``: those steps make
    exactly the synchronizing calls they make without dumps; the
    device-busy shares, ms to encode a 448² panel; (d) the evaluate CLI's
    ``profile_dir`` on 2 Synthetic objects, 3 clicks (host protocol, 12 A
    + 25 B a click): the ``torch.profiler`` trace it writes holds CUDA
    kernel events, B's among them;
11l. int8, W8A8 serving (main paths 92-97: ``dtype=int8`` of the
    evaluate CLI, ``load_model_for_eval(..., "int8")``), against
    ``isegprobe_torch/fixtures/synthetic_int8.npz``: kernels H (rows of
    [16400, 384], [16400, 1536] and [2050, 384] in bf16 and f32, the weights
    [1152, 384], [1536, 384], [384, 1536]) and I (the persistent ``wgmma``
    s8 GEMM: the flagship's four products at M = 16400 and 2050, MaskCLIP's
    four at M = 2·785, its packed in_proj with the bias after the cast, one
    f32 output) bit for bit against their plain versions, timed beside
    their bounds, the plain versions and the yardsticks ``torch._int_mm``
    with the plain epilogue and bf16 ``F.linear``; I also bit for bit at
    the ragged M ∈ {1, 127, 129, 2050} × N ∈ {8, 200, 2304} × K ∈ {32, 96,
    3072}, writing f32 and bf16, with no bias and the bias before and
    after the cast (I's ptxas entries: no spill, no C7515 line in
    ``quant.cu``); the trained flagship in int8, whose weights' int8 rows
    are quantized on its first forward and kept: one 448² batch-2 forward
    within 2^-6 of JAX's int8 logit scale and 0.08 in probability of the
    bf16 forward, exactly 12 A + 25 B + 48 I + 48 H + 48 H of the weights
    on the first forward and 12 A + 25 B + 48 I + 48 H on the next (bitwise
    the first), ms a forward at batch 2 and 16 beside bf16's; the device
    loop at B=8 on the 78 objects beside bf16's (NoC on the fixture's 24
    objects within 0.1 of JAX's int8, the distance to JAX's f32 NoC
    printed, every step 1 C + 12 A + 25 B + 48 I + 48 H); host clicks on 2
    objects (p50, exact launches); the trained MaskCLIP in int8 on the card
    against its CPU plain path at 224² (within 0.05 of the logit scale; 11
    A + 25 B + 45 I + 45 H, and 45 H of the weights on its first forward);
    the drawn DINO key probe in int8 (11 A + 23 B + 45 I + 45 H, and 45 H of
    the weights first); the trained 448² LoftUp in int8 (padded, D at dh
    128) through a loop of 2 objects × 4 clicks beside JAX's f32
    trajectories (48 H of the weights on its first step);
11m. demo_parallel, the interactive demo and ``parallel/`` (main paths
    98-104: ``python -m isegprobe_torch.demo``'s builder and
    ``interactive_demo/controller.py``, data and tensor parallelism on
    ``torch.distributed``, the multi-device evaluators, the evaluate CLI's
    ``device_mesh``), on the trained flagship unless named: (b) two gloo
    ranks on the one card, spawned (a ``FileStore``, joined with a
    timeout), each a data-parallel step (224², 4 rows a rank, 2 simulated
    clicks drawn for the global batch) within 1e-6 in loss and 1e-5 of
    each leaf's norm of one rank's step on the 8 rows (the same
    ``init_tree(config, 0)`` flagship; exactly 36 A + 75 B + 2 C), and the
    tensor-parallel forward (1 × 2: 3 heads a rank in kernel A, 12 A + 25 B)
    within 1e-5 of the logit scale of the replicated forward; meanwhile in
    this process an NCCL group of one (``HashStore``) whose step is
    bitwise the plain step; (a) the demo's predictor builder and
    controller, headless, at the fixture's clicks on 2 objects: every
    map bitwise the host ``Predictor``'s, undo bitwise, the finished mask,
    its PNG read back, exactly one forward's launches a click (a host
    click's), p50 ms a controller click beside a host click; (c) the mesh
    evaluator (16 lanes over ``[cuda:0, cuda:0]``) and one job queue a
    device on the 78 objects, lane for lane equal to the one-device loop at
    8 lanes (NoC equal, and within 0.05 of the fixture's 3.2821 / 3.4615 /
    4.3590), and the evaluate CLI with ``device_mesh=true`` (lockstep and
    with ``device_refill``) on the first 16 objects: one warning (one
    visible GPU), results equal to the command without it;
11n. extended_data, the extended training loaders (main path 105:
    ``data/datasets/extended.py`` on the committed trees
    ``isegprobe_torch/fixtures/datasets/{coco_lvis,lvis,coco,ade20k,
    openimages}/`` and their fixture ``extended_datasets.npz``): (a) every
    file decoded in colour and unchanged to cv2's digests (progressive
    JPEGs, interlaced and 1-bit PNGs among them), ms a progressive and a
    baseline decode; (b) each loader's items (SBD's train augmentations,
    ``stuff_prob`` 0.3, the hierarchy sampler) against JAX's digests, ms
    an item a loader, and the composed set's items from 4 loader threads
    and 4 spawned processes; (c) the full-width ``sbd_dinov2_noup`` step
    twice on the composed batch against JAX's losses (within
    ``TRAIN_LOSS_RTOL``) and leaves, exactly 2 × (12 A + 25 B); (d) eight
    trainer steps at 224², batch 8, fed by the composed set through the
    threaded loader with simulated clicks (every step (1 + num_iters) ×
    (12 A + 25 B) + num_iters C), median ms a step (CUDA events, host
    wall), data wait, peak memory;
12. the learned-upsampler families, LoftUp and JBU-FeatUp on DINOv2-S/14 at
    448² (drawn, calibrated): kernels D (cross-attention, f32 and bf16, at
    every tile and load path as A) and E (JBU filter; also at the edges of
    its tiling and on bases off 16-byte alignment) against their plain
    versions at the families' shapes, timed beside them; for each family
    one f32 forward on the card against the CPU with its exact launches per
    forward (LoftUp 12 A + 82 B + 14 D, JBU 12 A + 25 B + 4 E; LoftUp also
    one bf16 forward, checked as the flagship's), the host protocol (main path 3 and 5: p50 ms per
    click), the device loop at B=4 (main paths 4 and 6: every step 1 C plus
    one forward's launches, trajectories equal to B=1 and to the host
    Predictor; the JBU loop also under the sync debugger, and in bf16 beside
    it: every step 1 C + 12 A + 25 B + 4 E, NoC within 0.1 of the f32
    loop's, the first click where the two part, ms a step), and the split
    of one loop step into backbone, upsampler and head, with a profiler
    breakdown of the LoftUp forward by kernel;
13. the attention-variant sweep: kernels F (nodiv) and G (merged) against
    their plain versions at every query tile and exp dtype they take, at
    [2, 1025, 1152], at the sweep's [16, 1025, 1152] and at the ragged
    [3, 77, 768] (4 heads), in f32 and bf16, and bit for bit against the
    core they share with kernel A (G equals F at the same tile and exp; F
    with an f32 exp equals A at the same plan);
    their plain versions and SDPA timed at the sweep's shape. Then main
    path 7, the sweep through its package entry (``isegprobe_torch.scripts.
    bench_attn_variants.main``): every variant within tolerance of the f32
    reference and timed (the kernel times of F and G in the ``kernels``
    line), with every counter set to 0 just before and read just after, and
    each variant's kernel launched exactly as often as the sweep calls it;
14. print the ``{"kernels": [...]}`` line (kernels A-I and B's backward,
    ``layernorm_bwd``, with its launches on the training and BRS paths and
    its cases alone; launches by path,
    the training and other-backbone paths among them, A, B, D and E with
    their forward + backward times at the train steps' shapes (D also
    SDPA's), A and B with their times at the other backbones' shapes,
    the flash core named beside A, D, F and G,
    the flagship's and LoftUp's bf16 forwards among the paths, phase
    11g's bf16 training paths and A, B, D and E's bf16 forward + backward
    under autograd; H and I at 11l's shapes with their yardsticks; A, F
    and G
    also in bf16 at the sweep's shape, D at the LoftUp loop's; A and D with
    the plan their wrapper picked, E with the tiling and resources its
    library reports and its ptxas entry, C with its layout, its ptxas
    entry and its times on each of the three inputs) and,
    last, the ``{"ok": true, "device":
    ...}`` line.

Imports nothing of JAX or of the JAX package. Exits non-zero without a
result when CUDA is not available or the port cannot be imported.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

# Hopper H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the roofline that
# every bound_ms is computed against
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# special-function (exp) rate of the H100 SXM, from the FlashAttention-3
# paper (Shah et al., 2024: "3.9 TFLOPS of special functions"):
# an attention's B·H·Nq·Nk exps bound it as much as its bf16 products
PEAK_EXPS_PER_S = 3.9e12

# max |kernel - plain| <= ATOL + RTOL * |plain|: f32 differs only in
# summation order (and rsqrtf / the online softmax, ~1e-6 relative); bf16
# outputs may differ by one bf16 rounding step (2^-8 relative). Kernel E's
# output is a weighted mean of 49 inputs, which errs relative to the inputs
# summed, not to the mean, so its ATOL is scaled by max |hr|.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
# full forward, card vs CPU: f32 through 12 blocks and the conv head
FORWARD_RTOL = 1e-3
# first-click probabilities, card vs CPU predictor
PROBS_ATOL = 1e-3
# a bf16 forward (params cast to bf16) against the f32 forward on the card:
# bf16 weights, activations and attention probabilities through 12 blocks
# (the flagship's differed by 0.0149 at a logit scale of 1.07 with the
# lane-per-row attention kernel that preceded the flash core)
BF16_LOGIT_RTOL = 0.05

MAX_CLICKS = 5

# device loop: B=8 against B=1 and against the host Predictor. On the card
# the batch size may change cuBLAS's algorithm and so the f32 summation
# order, and a pixel at the 0.49 threshold may flip: per-click IoU within
# 1e-3, click counts equal. The picked target IoU keeps STOP_MARGIN from
# every IoU reached, so such a difference cannot move a stop.
LOOP_CLICKS = 20
LOOP_BATCH = 8
LOOP_JOBS = 10
LOOP_IOU_TOL = 1e-3
# the clicker's row pass in the device loop at B=8: 2 error maps of 480x640
# scenes padded by one pixel
EDT_SHAPE = (LOOP_BATCH, 2, 514, 642)
STOP_MARGIN = 2e-3
# trunk cache: the same arithmetic from a cached trunk
CACHE_TOL = 1e-4
# share of a seeded scene's pixels a drawn probe marks positive
POSITIVE_SHARE = 0.03
# what one forward of each probe launches (LoftUp at 448²: 7 slabs of 64
# rows, each 2 cross-attention layers of kernel D and 8 LayerNorms, plus the
# ChannelNorm of its input; JBU: 4 stages of kernel E)
FORWARD_LAUNCHES = {
    "flagship": {"mha_qkv": 12, "layernorm": 25},
    "loftup": {"mha_qkv": 12, "layernorm": 25 + 1 + 7 * 8, "mha": 14},
    "jbu_featup": {"mha_qkv": 12, "layernorm": 25, "jbu_filter": 4},
}
KERNELS = ("edt_row_envelope", "mha_qkv", "layernorm", "mha", "jbu_filter",
           "mha_qkv_nodiv", "mha_qkv_merged", "quantize_rows", "int8_gemm")
# what the loop's steps must launch, per step
PER_STEP = {"edt_row_envelope": 1, **FORWARD_LAUNCHES["flagship"]}
# the learned-upsampler families: crop size, device loop batch, clicks and
# scenes
FAMILY_SIZE = 448
FAMILY_BATCH = 4
# 6 clicks keep the run within its time (a LoftUp loop step is ~0.8 s)
FAMILY_CLICKS = 6
FAMILY_JOBS = 4
# a larger positive share than the flagship's: at 3% the drawn JBU probe's
# masks missed every object on every click (IoU 0 throughout), so no target
# IoU could stop its lanes at different clicks
FAMILY_POSITIVE_SHARE = 0.15
UPSAMPLERS = {
    "loftup": dict(type="loftup", params=dict(upsampler_path=None,
                                              n_dim=384)),
    "jbu_featup": dict(type="jbu_featup", params=dict(backbone_type="dinov2",
                                                      use_norm=True)),
}

# int8 W8A8 serving (phase 11l): the JAX package's int8 results for the
# trained flagship (isegprobe_torch/fixtures/synthetic_int8.npz: its device
# loop on the first 24 objects, one 448² batch-2 forward's logits). A W8A8
# layer launches one I and two H (its input's rows and its weight's): the
# DINOv2 trunk has 12 × 4 such layers, MaskCLIP 11 × 4 and its last block's
# out_proj, the DINO key probe 11 × 4 and its last block's qkv. Gates: the
# forward within 2^-6 of JAX's int8 logit scale (the bf16 probes'
# tolerance) and within 0.08 in probability of the bf16 forward (the JAX
# package's own int8 bound), NoC within 0.1 of JAX's int8 NoC on the
# fixture's objects, MaskCLIP's card forward within 0.05 of the logit scale
# of its CPU plain path (at 224², batch 2: the CPU's share of the phase)
INT8_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
                / "fixtures" / "synthetic_int8.npz")
INT8_LOGIT_TOL = 2.0**-6
INT8_PROB_TOL = 0.08
INT8_NOC_TOL = 0.1
INT8_MASKCLIP_TOL = 0.05
INT8_HOST_OBJECTS = 2
INT8_CLIP_SIZE = 224


# the trained probes (isegprobe_torch/evaluate.py) on the JAX package's
# Synthetic scenes: the checkpoints, their frozen parameters (rebuilt from
# PRNGKey(0)), evaluate.py's protocol (20 clicks, target IoU 0.9, threshold
# 0.5), the loop's batch, the objects of the host protocol and of the
# LoftUp leg against JAX (the timed LoftUp report runs the first
# TRAINED_LOFTUP_TIMED_OBJECTS at FAMILY_BATCH lanes and FAMILY_CLICKS),
# and the gates against the JAX
# results: at most
# TRAINED_MAX_DIVERGED of the 78 objects may click differently (a pixel at
# p = 0.5 or a tied deepest error can flip between CPU JAX and the card),
# NoC within TRAINED_NOC_TOL
TRAINED_CKPTS = {
    name: str(Path(__file__).resolve().parent / "assets" / "trained" / ckpt)
    for name, ckpt in (("flagship", "synthetic_dinov2_noup_160ep.ckpt"),
                       ("loftup", "synthetic_dinov2_loftup448_160ep.ckpt"),
                       ("maskclip", "synthetic_maskclip_noup_160ep.ckpt"))}
TRAINED_FROZEN = {"flagship": 22_056_192, "loftup": 22_056_192 + 4_305_510,
                  "maskclip": 81_468_672}
TRAINED_CLICKS = 20
TRAINED_TARGET = 0.9
TRAINED_THRESH = 0.5
TRAINED_BATCH = 8
TRAINED_SCENE = 256
TRAINED_HOST_OBJECTS = 8
TRAINED_LOFTUP_OBJECTS = 2
TRAINED_LOFTUP_CLICKS = 4
# the timed LoftUp loop's objects: the first 4 of the 78 (all 78 took
# 122 s of the run, the first 16 25 s, the first 8 12.7 s)
TRAINED_LOFTUP_TIMED_OBJECTS = 4
TRAINED_MAX_DIVERGED = 2
TRAINED_NOC_TOL = 0.05
# the trained bf16 loops' NoC@80/85/90 against the JAX f32 results: bf16
# may move a click of an object (1/78 = 0.0128 of NoC); up to three such
# moves pass
TRAINED_BF16_NOC_TOL = 0.04

# the other backbones (isegprobe_torch.models.probe_model.synthetic_config):
# the trained MaskCLIP probe held against the JAX device evaluator's
# results in isegprobe_torch/fixtures/synthetic_maskclip.npz (all 78
# objects) as the flagship's are, its bf16 loops'
# NoC within MASKCLIP_BF16_NOC_TOL of JAX's f32 NoC; the drawn DINO ViT key
# probe, DINOv2 + SimpleViT (trunk cache) and DINOv2 + LiFT at 448² through
# a forward against the CPU and a short f32 loop of FAMILY_BATCH lanes on
# the drawn scenes; the linear and simple_conv heads on the DINO probe.
# What one forward launches: MaskCLIP runs 11 attention blocks and its last
# block's value path (ln_pre, 11 × 2, the last ln_1, ln_post); the key
# probe stops at the last block's keys (11 blocks and its norm1); the
# SimpleViT click encoder adds 6 attention blocks and 15 LayerNorms
# (patch_norm1 and 2, 6 × 2, final_norm)
MASKCLIP_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
                    / "fixtures" / "synthetic_maskclip.npz")
MASKCLIP_BF16_NOC_TOL = 0.1
SIMPLEVIT_LAUNCHES = {"mha_qkv": 6, "layernorm": 15}
OTHER_FORWARD_LAUNCHES = {
    "maskclip_noup": {"mha_qkv": 11, "layernorm": 25},
    "vit_noup": {"mha_qkv": 11, "layernorm": 23},
    "dinov2_simplevit": {"mha_qkv": 12 + 6, "layernorm": 25 + 15},
    "dinov2_lift": {"mha_qkv": 12, "layernorm": 25},
}
OTHER_CLICKS = 5
# what one int8 forward launches once its weights' int8 rows are cached
# (phase 11l; LoftUp in its padded layout): one H an activation, one I a
# product; the first forward of a loaded model adds one H a weight
INT8_LAUNCHES = {
    "flagship": {**FORWARD_LAUNCHES["flagship"], "int8_gemm": 48,
                 "quantize_rows": 48},
    "loftup": {**FORWARD_LAUNCHES["loftup"], "int8_gemm": 48,
               "quantize_rows": 48},
    "maskclip_noup": {**OTHER_FORWARD_LAUNCHES["maskclip_noup"],
                      "int8_gemm": 45, "quantize_rows": 45},
    "vit_noup": {**OTHER_FORWARD_LAUNCHES["vit_noup"], "int8_gemm": 45,
                 "quantize_rows": 45},
}
# kernel I bitwise at ragged shapes (phase 11l): M x N x K
INT8_RAGGED = ((1, 127, 129, 2050), (8, 200, 2304), (32, 96, 3072))


def int8_first_forward(per_forward: dict) -> dict:
    """A loaded int8 model's first forward: one more H a weight (the
    weights' rows are quantized once, then cached)."""
    return {**per_forward, "quantize_rows": 2 * per_forward["int8_gemm"]}

# the RITM adaptive protocol and continuous batching (phase 11e): the JAX
# package's adaptive results for the trained flagship (its device loop on
# every object, its host chain on the first 8), the RITM scalar target and
# skip_clicks, the 224² scenes' adaptive canvas (256² padded frames:
# ceil14(max(256, 400)) = 406, 29² patches and the cls token), refill
# against lockstep (the same arithmetic for every lane: equality is
# expected), the bf16 loop's NoC against JAX's f32, the
# adaptive loop's launches a step (the clicker and the masked forward's
# LayerNorms: its attention is the plain masked path, no kernel), and the
# drawn SimpleViT probe's queue (jobs, lanes, clicks)
RITM_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
                / "fixtures" / "synthetic_ritm.npz")
RITM_TARGET = 400
RITM_SKIP_CLICKS = 1
RITM_TOKENS = 1 + (406 // 14) ** 2
REFILL_TOL = 1e-4
RITM_BF16_NOC_TOL = 0.1
ADAPTIVE_PER_STEP = {"edt_row_envelope": 1, "layernorm": 25}
REFILL_FAMILY_JOBS = 7

# training (isegprobe_torch/train.py, models/synthetic/dinov2_noup.py):
# the JAX items and train step stored in the fixture, the step's shapes
# (batch 8 at 224²: 257 tokens), an epoch of 96 items with 4 loader
# threads, and the gates: gradients of A and B under autograd against
# autograd through the plain version (1e-5 of the gradient scale; A's
# backward is that plain version recomputed, B's a kernel of its own);
# images of the items within 1 grey level on 0.1% of pixels (the
# float64 noise resize may round a value the other way), masks and points
# equal; the two steps' losses within 1e-5 relative of JAX's and the
# trainable leaves within the tolerances of tests/test_torch_training.py;
# the checkpoint read back at the pretraining grid within 1e-5 of the
# logit scale
TRAIN_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
                 / "fixtures" / "synthetic_train_step.npz")
TRAIN_BATCH = 8
TRAIN_CROP = 224
TRAIN_STEPS = 12
TRAIN_WORKERS = 4
TRAIN_GRAD_TOL = 1e-5
# under autograd the backward of A, D and E is the plain version's VJP
# recomputed, so their gradients equal autograd through the plain version
# but for the forward's rounding; B's backward is a kernel of its own
# (csrc/layernorm.cu), the closed form of that VJP summed in another order
# (~1e-6 of the scale measured). Either way: 1e-5 of the scale in f32, one
# bf16 step (2^-8) in bf16
GRAD_TOL = {"float32": TRAIN_GRAD_TOL, "bfloat16": 2.0**-8}
# what B's backward launches on the flagship's train step: its 25
# LayerNorms take dx alone (the backbone's weights are frozen), one launch
# each
FLAGSHIP_B_BACKWARD = 25
TRAIN_IMAGE_TOL = {"grey_levels": 1, "pixel_share": 1e-3}
TRAIN_LR = 5e-5
TRAIN_LOSS_RTOL = 1e-5
TRAIN_DIGEST_RTOL = 1e-4
TRAIN_DIGEST_ATOL = 2.5e-4
TRAIN_FLIPS = 10
TRAIN_READBACK = 518
TRAIN_READBACK_TOL = 1e-5

# training the other Synthetic probes (phase 11f: isegprobe_torch/train.py
# with every script of models/synthetic/): the JAX train steps stored in
# the families' fixture (on the first FIXTURE items of the train-step
# fixture's batch), what one forward of each family's 224² probe launches
# (LoftUp runs its 50,176 query pixels whole, under its 120,000 threshold:
# its input ChannelNorm, the stem's norm, 2 layers of 3 norms and one D,
# the transformer's final norm), the command-line runs' items, and
# LoftUp's banded step at 448²: 7 slabs of 64 rows, each recomputed in the
# backward (its 8 B and 2 D launched again). The gates are phase 11c's:
# D and E under autograd as A and B (1e-5 of the gradient scale), the
# steps' losses and leaves as tests/test_torch_training.py holds them, the
# checkpoints read back within 1e-5 of the logit scale
FAMILY_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
                  / "fixtures" / "synthetic_train_step_families.npz")
FAMILY_TRAIN_LAUNCHES = {
    "dinov2_loftup": {"mha_qkv": 12, "layernorm": 25 + 1 + 8, "mha": 2},
    "dinov2_jbu": FORWARD_LAUNCHES["jbu_featup"],
    **OTHER_FORWARD_LAUNCHES,
}
FAMILY_GRID = TRAIN_CROP // 14  # 16² DINOv2 tokens at 224²
FAMILY_CLI_ITEMS = 32  # four steps at batch 8
FAMILY_CLI_VAL_ITEMS = 16
OTHER_CLI_ITEMS = 16  # two steps
OTHER_CLI_VAL_ITEMS = 8
BANDED_SIZE = 448
BANDED_BATCH = 8
BANDED_RECOMPUTE = {"layernorm": 7 * 8, "mha": 7 * 2}
# read back where neither side resizes a pos-embed: DINOv2's pretraining
# grid (37² at 518²), the DINO trunk's (14² at 224²); MaskCLIP resizes its
# table on every forward
# mixed-precision training (phase 11g): the JAX bf16 train steps stored in
# their fixture (flagship and LoftUp at 224², batch 8; the JAX package
# cannot train JBU in bf16, see tests/test_torch_bf16_training.py) and
# their gates: the losses within 2^-10 relative of JAX's, the leaves as
# 11c's with 64 sign flips (bf16 gradients' rounding noise; 23 on the CPU)
BF16_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
                / "fixtures" / "synthetic_train_step_bf16.npz")
BF16_LOSS_RTOL = 2.0**-10
BF16_FLIPS = 64
# the paper's data (phase 11h): the dataset trees and their fixture (cv2's
# pixel digests, the JAX package's SBD items and steps, the JAX device
# evaluator's trajectories of the trained flagship), the loader's workers,
# the command-line runs' items (two steps at batch 8) and the evaluation
DATA_TREES = (Path(__file__).resolve().parent / "isegprobe_torch"
              / "fixtures" / "datasets")
DATA_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
                / "fixtures" / "datasets.npz")
DATA_WORKERS = 4
DATA_SEEDS = (0, 1)
DATA_CLI_ITEMS = 16
DATA_CLI_VAL_ITEMS = 8
DATA_EVAL = ("GrabCut", "Berkeley", "DAVIS", "SBD", "PascalVOC")
DATA_PATH_KEYS = {"SBD": "sbd", "GRABCUT": "grabcut", "BERKELEY": "berkeley",
                  "DAVIS": "davis", "PASCALVOC": "pascalvoc"}
# the extended training loaders (phase 11n): the five trees and their
# fixture (cv2's pixel digests in colour and unchanged, the JAX items of
# each loader and of the composed set, the JAX step on the composed batch),
# RITM's COCO-LVIS stuff probability, the trainer's steps
EXT_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
               / "fixtures" / "extended_datasets.npz")
EXT_LAYOUTS = ("coco_lvis", "lvis", "coco", "ade20k", "openimages")
EXT_STUFF_PROB = 0.3
EXT_STEPS = 8
# the bf16 JBU loop's NoC against the f32 loop's (PERF.md section 2)
JBU_BF16_NOC_TOL = 0.1
FAMILY_READBACK = {"dinov2_loftup": 518, "dinov2_jbu": 518,
                   "dinov2_lift": 518, "dinov2_simplevit": 518,
                   "vit_noup": 224, "maskclip_noup": 224}


def fail(msg: str):
    raise RuntimeError(msg)


_SCRATCH: list = []


def scratch() -> str:
    """A temporary directory for the trainers' run directories, made at
    first use and removed when the script exits."""
    if not _SCRATCH:
        import atexit
        import shutil
        import tempfile

        _SCRATCH.append(tempfile.mkdtemp(prefix="chip_smoke_"))
        atexit.register(shutil.rmtree, _SCRATCH[0], True)
    return _SCRATCH[0]


_INIT: dict = {}
# frozen parts (backbone, upsampler) by the config that draws them, shared
# by the trainers' initial trees and the evaluation loads: a checkpoint's
# frozen parts are init_tree(config, 0)'s for its backbone and upsampler
# config (isegprobe_torch.evaluate.load_model_for_eval's ``frozen``)
_FROZEN: dict = {}
_TRAINED_KEYS = ("embed_coords", "head")


def frozen_key(config: dict) -> str:
    """The part of a model config that the frozen parts depend on: the
    backbone without remat (which draws nothing) and the upsampler, an
    upsampler without parameters (identity, bilinear) as identity."""
    backbone = dict(config["backbone_cfg"])
    backbone["params"] = {k: v for k, v in (backbone.get("params")
                                            or {}).items()
                          if k != "remat_blocks"}
    upsampler = config.get("upsampler_cfg") or {"type": "bilinear"}
    if upsampler["type"] in ("identity", "bilinear"):
        upsampler = {"type": "identity"}
    return json.dumps([backbone, upsampler], sort_keys=True)


def remember_frozen(config: dict, tree: dict) -> None:
    _FROZEN.setdefault(frozen_key(config), {
        k: v for k, v in tree.items() if k not in _TRAINED_KEYS})


def eval_load(torch, ckpt, dtype, size=(448, 448), **kw):
    """``load_model_for_eval``, with the frozen parts of an earlier load or
    trainer of the same backbone and upsampler config when there is one
    (``info["init_seconds"]`` is then ~0)."""
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.utils.serialization import load_checkpoint

    config = load_checkpoint(str(ckpt))[1]["params"]
    model, info = load_model_for_eval(
        str(ckpt), dtype, size, frozen=_FROZEN.get(frozen_key(config)),
        **kw)
    remember_frozen(config, info["frozen"])
    return model, info


def initial_tree(argv) -> dict:
    """The script's ``init_tree(config, 0)`` for the command line ``argv``,
    drawn once per model config and reused by later calls (the numpy draw
    of a full-width backbone takes 3-11 s)."""
    from isegprobe_torch import train as train_cli
    from isegprobe_torch.models.init_tree import init_tree
    from isegprobe_torch.utils.serialization import merge_params

    cfg = train_cli.parse_args(argv)
    config = train_cli.model_kwargs(cfg)
    # scripts that build the same parameters share a tree: remat draws
    # nothing, and neither does an upsampler without parameters (identity,
    # bilinear), whose probe's tree is the identity probe's
    # (tests/test_torch_sbd_training.py); the frozen parts may come from
    # an evaluation load of the same config
    key = json.dumps([frozen_key(config), {
        k: v for k, v in config.items()
        if k not in ("backbone_cfg", "upsampler_cfg")}], sort_keys=True)
    if key not in _INIT:
        frozen = _FROZEN.get(frozen_key(config))
        if frozen is None:
            _INIT[key] = init_tree(config, 0)
            remember_frozen(config, _INIT[key])
        else:
            _INIT[key] = merge_params(frozen, init_tree(config, 0,
                                                        skip=frozen))
    return _INIT[key]


def build(argv, **kw):
    """``isegprobe_torch.train.build_trainer`` of the command line ``argv``
    from :func:`initial_tree` (the tree the trainer would draw)."""
    import warnings

    from isegprobe_torch import train as train_cli

    params = initial_tree(argv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LoftUp's missing upsampler_path
        return train_cli.build_trainer(train_cli.parse_args(argv),
                                       params=params, **kw)


def _leaves(tree) -> list:
    """The leaves of a nested dict, in order."""
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if not out:
        fail("nvidia-smi printed nothing")
    return out.splitlines()[0]


def time_ms(torch, fn, reps: int = 20, rounds: int = 5,
            graph: bool = True, warmup: int = 3) -> tuple[float, str]:
    """Median device ms per call of ``fn`` over ``rounds`` rounds of
    ``reps`` calls between CUDA events, after ``warmup`` calls. With
    ``graph`` the calls are
    captured in one CUDA graph and replayed, so host launch cost does not
    count (a kernel of a few microseconds is otherwise timed at the host's
    launch rate); if capture fails the eager loop is timed instead. Returns
    the time and the method used."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    method = "eager"
    if graph:
        try:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                run()
            g.replay()
            run, method = g.replay, "cuda_graph"
        except RuntimeError as e:
            print(f"graph capture failed ({e}); timing eagerly")
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times)), method


def compare(torch, got, want, dtype: str, scale: float = 1.0) -> dict:
    rtol, atol = TOL[dtype]
    atol *= scale
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all()) and bool(
        torch.isfinite(g).all())
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / w.abs().clamp_min(1.0)).max()),
            "rtol": rtol, "atol": atol, "ok": ok}


def plan_records(torch, entry, args, plans, want, dtype, what: dict,
                 chosen) -> list:
    """Hold the kernel behind ``entry(*args, plan=...)`` against ``want``
    at every forced (q_tile, aligned) in ``plans`` other than ``chosen``
    (the plan the wrapper picks itself), each timed: one record each,
    marked ``forced``."""
    records = []
    for plan in plans:
        if plan == chosen:
            continue
        got = entry(*args, plan=plan)
        torch.cuda.synchronize()
        res = compare(torch, got, want, dtype)
        del got
        res["ms"], res["timing"] = time_ms(
            torch, lambda: entry(*args, plan=plan))
        res.update(what, plan=list(plan), forced=True)
        records.append(res)
    return records


def every_plan(attention, dtype: str, dh: int) -> list:
    """Every (q_tile, aligned) kernels A and D take at this dtype and dh."""
    vec = 8 if dtype == "bfloat16" else 4
    paths = [False] + ([True] if dh % vec == 0 else [])
    return [(t, a) for t in attention.Q_TILES for a in paths]


def attention_case(torch, F, attention, b, n, heads, dh, dtype, seed,
                   all_plans: bool = False) -> list:
    """Check and time the attention kernel at one shape, at the plan the
    wrapper picks (recorded, with the plain version's, SDPA's and the bound
    beside it) and, with ``all_plans``, at every other tile and load
    path."""
    tdt = getattr(torch, dtype)
    c = heads * dh
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda").to(tdt)
    scale = dh**-0.5
    got = attention.mha_qkv(qkv, heads, scale)
    want = attention._mha_qkv_plain(qkv, heads, scale)
    torch.cuda.synchronize()
    res = compare(torch, got, want, dtype)
    q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    res["ms"], res["timing"] = time_ms(
        torch, lambda: attention.mha_qkv(qkv, heads, scale))
    res["plain_ms"], _ = time_ms(
        torch, lambda: attention._mha_qkv_plain(qkv, heads, scale))
    res["library_ms"], _ = time_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    itemsize = qkv.element_size()
    ops = 4.0 * b * heads * n * n * dh
    nbytes = (b * n * 3 * c + b * n * c) * itemsize
    res.update(_bound(ops, nbytes, dtype, exps=float(b * heads * n * n)))
    what = dict(kernel="mha_qkv", shape=[b, n, 3 * c], heads=heads, dh=dh,
                dtype=dtype)
    chosen = attention._plan(b, n, heads, dh, tdt, qkv.device)
    res.update(what, plan=list(chosen))
    records = [res]
    if all_plans:
        records += plan_records(torch, attention.mha_qkv, (qkv, heads, scale),
                                every_plan(attention, dtype, dh), want,
                                dtype, what, chosen)
    return records


def variant_cases(torch, F, attention, attn_variants, b, n, heads, dtype,
                  seed, timed: bool) -> list:
    """Hold kernels F (nodiv) and G (merged) against their plain versions at
    one shape, at every query tile and every exp dtype the entries take
    (bf16 inputs: f32 and bf16 exp), and bit for bit against the flash core
    they share with kernel A: G's output equals F's at the same tile and
    exp, and F's with an f32 exp equals A's at the same plan. With
    ``timed``, the default tile of each (kernel, exp) gets its plain
    version's and SDPA's times on the same q, k and v, and its bound; the
    kernel itself is timed by the sweep. One record each."""
    tdt = getattr(torch, dtype)
    c = heads * 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda").to(tdt)
    scale = 64**-0.5
    expdts = ["float32"] + (["bfloat16"] if dtype == "bfloat16" else [])
    q, k, v = qkv.view(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
    library_ms = None
    records = []
    kernel_f = {}  # (expdt, tile) -> F's output
    for name, entry, plain, tiles in (
            ("mha_qkv_nodiv", attn_variants.mha_qkv_nodiv,
             attn_variants._nodiv_plain, attn_variants.NODIV_TILES),
            ("mha_qkv_merged", attn_variants.mha_qkv_merged,
             attn_variants._merged_plain, attn_variants.MERGED_TILES)):
        for expdt in expdts:
            edt = getattr(torch, expdt)
            want = plain(qkv, heads, scale, edt)
            for tile in tiles:
                got = entry(qkv, heads, scale, expdt=edt, q_tile=tile)
                torch.cuda.synchronize()
                res = compare(torch, got, want, dtype)
                if name == "mha_qkv_nodiv":
                    kernel_f[expdt, tile] = got
                    if expdt == "float32":
                        same = torch.equal(got, attention.mha_qkv(
                            qkv, heads, scale, plan=(tile, True)))
                        res["bitwise_equal_kernel_a"] = same
                        res["ok"] = res["ok"] and same
                else:
                    same = torch.equal(got, kernel_f[expdt, tile])
                    res["bitwise_equal_kernel_f"] = same
                    res["ok"] = res["ok"] and same
                res.update(kernel=name, shape=[b, n, 3 * c], heads=heads,
                           dtype=dtype, expdt=expdt, tile=tile)
                if timed and tile == tiles[0]:
                    res["plain_ms"], _ = time_ms(
                        torch, lambda: plain(qkv, heads, scale, edt), reps=3,
                        rounds=3, graph=False)
                    if library_ms is None:
                        library_ms, _ = time_ms(
                            torch, lambda: F.scaled_dot_product_attention(
                                q, k, v, scale=scale))
                    res["library_ms"] = library_ms
                    res.update(_bound(4.0 * b * heads * n * n * 64,
                                      4.0 * b * n * c * qkv.element_size(),
                                      dtype, exps=float(b * heads * n * n)))
                records.append(res)
            del want
    del kernel_f
    return records


def layernorm_case(torch, F, layernorm, rows_shape, d, dtype, seed,
                   eps: float = 1e-6, real=None):
    """Check and time the LayerNorm kernel at one shape (weights in the IO
    dtype, as the model passes them). With ``real`` the statistics cover
    the first ``real`` channels and the rest of x, weight and bias are
    zeros, as in LoftUp's padded layout; no PyTorch call computes that
    function, so there is no library time."""
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((*rows_shape, d), generator=g, device="cuda") * 3 + 1
         ).to(tdt)
    w = (torch.randn(d, generator=g, device="cuda") * 0.5 + 1).to(tdt)
    bias = torch.randn(d, generator=g, device="cuda").to(tdt)
    if real is not None:
        x[..., real:], w[real:], bias[real:] = 0, 0, 0
    got = layernorm.layernorm(x, w, bias, eps, real)
    want = layernorm._ln_plain(x, w, bias, eps, real)
    torch.cuda.synchronize()
    res = compare(torch, got, want, dtype)
    if real is not None and got[..., real:].any():
        res["ok"] = False  # padded channels must stay exact zeros
    res["ms"], res["timing"] = time_ms(
        torch, lambda: layernorm.layernorm(x, w, bias, eps, real))
    res["plain_ms"], _ = time_ms(
        torch, lambda: layernorm._ln_plain(x, w, bias, eps, real))
    res["library_ms"] = None if real is not None else time_ms(
        torch, lambda: F.layer_norm(x, (d,), w, bias, eps))[0]
    n = x.numel()
    nbytes = 2 * n * x.element_size() + 2 * d * w.element_size()
    ops = 8.0 * n  # sum, square-sum, centre, scale, affine (f32 math)
    res.update(_bound(ops, nbytes, "float32"))
    res.update(kernel="layernorm", shape=list(x.shape), dtype=dtype,
               **({"real": real} if real is not None else {}))
    return res


def edt_case(torch, edt, gcol, kind: str, timed: bool = True):
    """Hold kernel C bitwise against its plain version on one column-pass
    output ``gcol`` (``bench_edt.column_input`` or ``domain_inputs``),
    timed beside it. C's work depends on the data; its bound counts what
    the function needs: ~20 integer operations a source for an envelope,
    and g read and the result written once (bytes bound it). No single
    PyTorch call computes this function, so there is no library time."""
    got = edt.row_envelope(gcol)
    want = edt._row_envelope_plain(gcol)
    torch.cuda.synchronize()
    res = {"max_abs_err": float((got - want).abs().max()),
           "bitwise_equal": bool(torch.equal(got, want)),
           "clamped_values": int((want == edt.BIG2).sum())}
    res["ok"] = res["bitwise_equal"] and res["max_abs_err"] == 0.0
    if timed:
        res["ms"], res["timing"] = time_ms(torch,
                                           lambda: edt.row_envelope(gcol))
        res["plain_ms"], _ = time_ms(
            torch, lambda: edt._row_envelope_plain(gcol))
        res["library_ms"] = None
    w = gcol.shape[-1]
    rows = gcol.numel() // w
    res.update(_bound(20.0 * rows * w, 8.0 * rows * w, "float32"))
    res.update(kernel="edt_row_envelope", input=kind,
               shape=list(gcol.shape), rows=rows, dtype="float32")
    return res


def sdpa_backends(torch, F, q, k, v, scale) -> list:
    """The fused backends of ``scaled_dot_product_attention`` that take
    these inputs (the math backend takes everything)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                with sdpa_kernel(backend):
                    F.scaled_dot_product_attention(q, k, v, scale=scale)
                names.append(backend.name)
            except RuntimeError:
                pass
    return names


def cross_attention_case(torch, F, attention, b, nq, nk, heads, dh, dtype,
                         seed, all_plans: bool = False) -> list:
    """Check and time kernel D at one shape, at the plan the wrapper picks,
    beside its plain version and ``scaled_dot_product_attention``
    (recording which fused backends take the shape; the default picks the
    first, else the math backend) and, with ``all_plans``, at every other
    tile and load path."""
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, nq, heads, dh), generator=g, device="cuda").to(tdt)
    k = torch.randn((b, nk, heads, dh), generator=g, device="cuda").to(tdt)
    v = torch.randn((b, nk, heads, dh), generator=g, device="cuda").to(tdt)
    scale = dh**-0.5
    got = attention.mha(q, k, v, scale)
    want = attention._mha_plain(q, k, v, scale)
    torch.cuda.synchronize()
    res = compare(torch, got, want, dtype)
    del got
    res["ms"], res["timing"] = time_ms(
        torch, lambda: attention.mha(q, k, v, scale))
    res["plain_ms"], _ = time_ms(
        torch, lambda: attention._mha_plain(q, k, v, scale), reps=3,
        rounds=3, graph=False)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    res["library_backends"] = sdpa_backends(torch, F, qt, kt, vt, scale)
    res["library_ms"], _ = time_ms(
        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      scale=scale),
        reps=3, rounds=3, graph=False)
    ops = 4.0 * b * heads * nq * nk * dh
    nbytes = (2 * b * nq + 2 * b * nk) * heads * dh * q.element_size()
    res.update(_bound(ops, nbytes, dtype, exps=float(b * heads * nq * nk)))
    what = dict(kernel="mha", shape=[[b, nq, heads, dh], [b, nk, heads, dh]],
                dtype=dtype)
    chosen = attention._plan(b, nq, heads, dh, tdt, q.device)
    res.update(what, plan=list(chosen))
    records = [res]
    if all_plans:
        records += plan_records(torch, attention.mha, (q, k, v, scale),
                                every_plan(attention, dtype, dh), want,
                                dtype, what, chosen)
    del want
    return records


def misaligned(torch, t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (kernel E then copies 4 bytes at a time)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def jbu_case(torch, jbu, b, h, w, c, k, seed, aligned: bool = True):
    """Check and time kernel E at one shape (f32, temp 0.5, sigma 0.8, as
    the drawn probes carry), with hr and proj 16-byte aligned or not. No
    single PyTorch call computes this function, so there is no library
    time."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hr = torch.randn((b, h, w, c), generator=g, device="cuda")
    proj = torch.randn((b, h, w, k), generator=g, device="cuda")
    if not aligned:
        hr, proj = misaligned(torch, hr), misaligned(torch, proj)
    temp = torch.full((), 0.5, device="cuda")
    sigma = torch.full((), 0.8, device="cuda")
    got = jbu.jbu_filter(hr, proj, temp, sigma)
    want = jbu._jbu_plain(hr, proj, temp, sigma)
    torch.cuda.synchronize()
    res = compare(torch, got, want, "float32", float(hr.abs().max()))
    del got, want
    res["ms"], res["timing"] = time_ms(
        torch, lambda: jbu.jbu_filter(hr, proj, temp, sigma))
    res["plain_ms"], _ = time_ms(
        torch, lambda: jbu._jbu_plain(hr, proj, temp, sigma), reps=3,
        rounds=3, graph=False)
    res["library_ms"] = None
    px = b * h * w
    # 49 taps of a K-wide dot and a C-wide weighted sum, 2 ops a product;
    # hr and proj read once, out written once
    res.update(_bound(2.0 * jbu.NTAP * (k + c) * px, 4.0 * (2 * c + k) * px,
                      "float32"))
    res.update(kernel="jbu_filter", shape=[b, h, w, c], key_dim=k,
               dtype="float32", aligned=aligned)
    return res


def _bound(ops: float, nbytes: float, op_dtype: str,
           exps: float = 0.0) -> dict:
    """The least time for the work: the largest of the products (or other
    operations) at the dtype's peak, the exps at the special-function rate
    and the bytes at the memory rate; ``bound_by`` names which."""
    times = {"operations": ops / PEAK_OPS_PER_S[op_dtype] * 1e3,
             "exps": exps / PEAK_EXPS_PER_S * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by, "ops": ops,
            "exps": exps, "bytes": nbytes}


def scene(seed: int, hw=(480, 640)):
    """A numpy-drawn image with one elliptic object (uint8 image, int mask)."""
    rng = np.random.default_rng(seed)
    img = (rng.random((*hw, 3)) * 90).astype(np.uint8)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    cy, cx = rng.uniform(0.3, 0.7) * hw[0], rng.uniform(0.3, 0.7) * hw[1]
    ry, rx = rng.uniform(0.15, 0.3) * hw[0], rng.uniform(0.15, 0.3) * hw[1]
    gt = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1).astype(np.int32)
    img[gt == 1] = rng.integers(130, 255, size=3)
    return img, gt


class Scenes:
    """Scenes in the shape ``evaluate_dataset`` reads: one object each."""

    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def get_sample(self, index):
        image, gt = self.scenes[index]
        return types.SimpleNamespace(image=image, objects_ids=[1],
                                     gt_mask=lambda _: gt)


def check_probs(image, gt, probs, *_):
    """evaluate_sample callback: every answer is a probability map."""
    if probs.shape != gt.shape or not np.isfinite(probs).all() or (
            probs.min() < 0 or probs.max() > 1):
        fail("predictor returned bad probabilities")


def calibrate_classifier(torch, model, size: int,
                         share: float = POSITIVE_SHARE) -> float:
    """Set the classifier bias of a drawn probe so that ``share`` of one
    seeded scene's pixels (one click) are positive. A drawn probe's
    logits share one sign over the frame (its head's ReLU features have a
    common positive mean), so every click would answer the same mask and
    every trajectory would be flat; with a small positive share the mask is
    a few compact blobs that the ZoomIn ROI follows, so masks answer the
    crop, the clicks and the previous mask, the ROI moves and lanes stop at
    different clicks. Returns the bias."""
    img, _ = scene(7, (size, size))
    x = np.concatenate([img.astype(np.float32) / 255.0,
                        np.zeros((size, size, 1), np.float32)], axis=-1)
    pts = np.full((1, 40, 3), -1.0, np.float32)
    pts[0, 0] = (size / 2, size / 2, 0)
    with torch.no_grad():
        logits = model(torch.from_numpy(x[None]).cuda(),
                       torch.from_numpy(pts).cuda())["instances"]
        cut = torch.quantile(logits.float().flatten(), 1.0 - share)
        model.head.classifier.bias.sub_(cut)
    return float(model.head.classifier.bias.detach())


def click_lanes(n: int, hw, seed: int):
    """Random clicker inputs: elliptic ground truths with an ignore band,
    predictions that are other ellipses with 1% noise, a few clicked
    pixels; lane 0 has no error at all."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]

    def ellipse():
        cy, cx = rng.uniform(0.2, 0.8) * hw[0], rng.uniform(0.2, 0.8) * hw[1]
        ry, rx = rng.uniform(0.1, 0.3) * hw[0], rng.uniform(0.1, 0.3) * hw[1]
        return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1

    gts, preds, ncs = [], [], []
    for lane in range(n):
        obj = ellipse()
        gt = obj.astype(np.int32)
        if lane % 2:
            gt[:, rng.integers(0, hw[1] - 20):][:, :20] = -1
        pred = ellipse() ^ (rng.random(hw) < 0.01)
        if lane == 0:
            pred = obj.copy()
        gts.append(gt), preds.append(pred)
        ncs.append(rng.random(hw) > 0.001)
    return np.stack(gts), np.stack(preds), np.stack(ncs)


def pick_target(trajectories, max_clicks: int):
    """The target IoU, from trajectories run to ``max_clicks``, at which the
    lanes stop at the most distinct clicks, at least STOP_MARGIN from every
    IoU reached. Returns (target, the stop click of each lane); fails when
    no target stops the lanes at two different clicks."""
    best = find_target(trajectories, max_clicks)
    if best is None:
        fail(f"no target IoU stops the lanes at different clicks: "
             f"{trajectories}")
    return best


def find_target(trajectories, max_clicks: int):
    """As ``pick_target``; None when no target splits the lanes."""
    values = sorted({float(v) for t in trajectories for v in t})
    best = None
    for lo, hi in zip(values, values[1:]):
        if hi - lo < 2 * STOP_MARGIN:
            continue
        t = 0.5 * (lo + hi)
        stops = [next((k + 1 for k, v in enumerate(traj) if v >= t),
                      max_clicks) for traj in trajectories]
        key = (len(set(stops)), hi - lo)
        if best is None or key > best[0]:
            best = (key, t, stops)
    if best is None or best[0][0] < 2:
        return None
    return best[1], best[2]


def same_trajectories(got, want, tol: float, what: str) -> float:
    """Fail unless click counts are equal and IoUs within ``tol``; returns
    the largest IoU difference."""
    if [len(a) for a in got] != [len(b) for b in want]:
        fail(f"{what}: click counts {[len(a) for a in got]} != "
             f"{[len(b) for b in want]}")
    err = max((float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(got, want) if len(a)), default=0.0)
    if err > tol:
        fail(f"{what}: IoUs differ by {err} > {tol}")
    return err


def time_clicks(predictor) -> list:
    """Wrap ``predictor.get_prediction`` so that the host seconds of each
    call (it ends in a device-to-host copy) go to the returned list."""
    click_s: list = []
    timed = predictor.get_prediction

    def get_prediction(clicker):
        t = time.perf_counter()
        out = timed(clicker)
        click_s.append(time.perf_counter() - t)
        return out

    predictor.get_prediction = get_prediction
    return click_s


def first_chunk(torch, device_eval, scenes, batch: int) -> list:
    """The device loop's (image, gt, valid) inputs for the first ``batch``
    scenes, on the card."""
    jobs = [device_eval._pad_job(img, gt, 64) for img, gt in scenes[:batch]]
    chunk = [torch.from_numpy(np.stack([j[k] for j in jobs])).cuda()
             for k in range(3)]
    torch.cuda.synchronize()
    return chunk


def sync_checked_run(torch, run, chunk, want, what: str) -> dict:
    """One whole device-loop evaluation of ``chunk`` under
    ``torch.cuda.set_sync_debug_mode("error")``, which the loop lifts only
    around its one allowed read per click: any other synchronising op, a
    debugger that does not catch a read, or trajectories other than
    ``want`` fail the run."""
    steps0, reads0 = run.steps, run.host_reads
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:  # the debugger is live: a plain read must raise
            bool(chunk[2].sum() > 0)
            live = False
        except RuntimeError:
            live = True
        ious, n = run(*chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps, reads = run.steps - steps0, run.host_reads - reads0
    if not live:
        fail("set_sync_debug_mode('error') did not catch a device read")
    if reads != steps + 1:
        fail(f"{what}: {reads} host reads in {steps} loop steps")
    ious, n = ious.cpu().numpy(), n.cpu().numpy()
    same_trajectories([ious[i][: int(n[i])] for i in range(len(n))], want,
                      CACHE_TOL, f"{what}: sync-checked run")
    return {"steps": steps, "host_reads": reads, "debugger_live": live}


def forward_vs_cpu(torch, model, cpu_model, size: int, per_forward: dict,
                   what: str, cpu_batch: int = 2) -> tuple:
    """One f32 forward at B=2 on the card: it must launch exactly
    ``per_forward``, give finite logits of the crop's shape, and agree
    within FORWARD_RTOL of the logit scale with the CPU forward of its
    first ``cpu_batch`` samples (lanes are independent). Returns (image,
    points and logits on the card, the record)."""
    rng = np.random.default_rng(0)
    image = rng.random((2, size, size, 4), dtype=np.float32)
    points = np.full((2, 40, 3), -1.0, np.float32)
    points[:, 0] = (200.0, 220.0, 0)
    points[0, 20] = (60.0, 400.0, 1)
    points[1, 1] = (300.0, 120.0, 1)
    img_d = torch.from_numpy(image).cuda()
    pts_d = torch.from_numpy(points).cuda()
    with torch.inference_mode():
        zero_counters()
        logits = model(img_d, pts_d)["instances"]
        torch.cuda.synchronize()
        got = {k: v for k, v in counters().items() if v}
        t0 = time.time()
        ref = cpu_model(torch.from_numpy(image[:cpu_batch]),
                        torch.from_numpy(points[:cpu_batch]))["instances"]
        cpu_s = time.time() - t0
        f32_ms, _ = time_ms(torch, lambda: model(img_d, pts_d), reps=3,
                            rounds=3, graph=False)
    err = float((logits[:cpu_batch].cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    record = {"launches_per_forward": got, "max_abs_err_vs_cpu": err,
              "logit_scale": scale, "cpu_forward_s": cpu_s,
              "f32_forward_ms": f32_ms, "shape": list(logits.shape)}
    print(f"{what} forward", json.dumps(record))
    if tuple(logits.shape) != (2, size, size, 1) or not bool(
            torch.isfinite(logits).all()):
        fail(f"{what}: bad logits, shape {tuple(logits.shape)}")
    if err > FORWARD_RTOL * max(1.0, scale):
        fail(f"{what}: card forward disagrees with the CPU forward: {err} "
             f"(logit scale {scale})")
    if got != per_forward:
        fail(f"{what}: expected {per_forward} launches per forward, got "
             f"{got}")
    return img_d, pts_d, logits, record


def bf16_forward(torch, model, cfg: dict, img_d, pts_d, logits,
                 per_forward: dict, what: str) -> dict:
    """One forward of ``model`` with its params cast to bf16 (as evaluate.py
    casts them), on the f32 forward's inputs: finite logits of the same
    shape within BF16_LOGIT_RTOL of the f32 logits' scale, with exactly
    ``per_forward`` launches; timed. Returns (the bf16 model, the
    record)."""
    from isegprobe_torch.models.probe_model import iSegProbeModel

    model16 = iSegProbeModel(**cfg).eval()
    model16.load_state_dict(model.state_dict())
    model16.to(torch.bfloat16)
    with torch.inference_mode():
        zero_counters()
        got = model16(img_d, pts_d)["instances"]
        torch.cuda.synchronize()
        launches = {k: v for k, v in counters().items() if v}
        ms, _ = time_ms(torch, lambda: model16(img_d, pts_d), reps=3,
                        rounds=3, graph=False)
    diff = float((got.float() - logits).abs().max())
    scale = float(logits.abs().max())
    record = {"launches_per_forward": launches, "bf16_forward_ms": ms,
              "bf16_vs_f32_max_abs_logit_diff": diff,
              "f32_logit_scale": scale, "shape": list(got.shape)}
    print(f"{what} bf16 forward", json.dumps(record))
    if got.shape != logits.shape or not bool(torch.isfinite(got).all()):
        fail(f"{what}: bad bf16 logits, shape {tuple(got.shape)}")
    if launches != per_forward:
        fail(f"{what}: expected {per_forward} launches per bf16 forward, "
             f"got {launches}")
    if diff > BF16_LOGIT_RTOL * scale:
        fail(f"{what}: bf16 forward differs from the f32 forward by {diff} "
             f"(logit scale {scale})")
    return model16, record


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from isegprobe_torch.ops import attention, attn_variants, edt, jbu
    from isegprobe_torch.ops import layernorm, quant

    return {"edt_row_envelope": edt.row_envelope,
            "mha_qkv": attention.mha_qkv, "layernorm": layernorm.layernorm,
            "mha": attention.mha, "jbu_filter": jbu.jbu_filter,
            "mha_qkv_nodiv": attn_variants.mha_qkv_nodiv,
            "mha_qkv_merged": attn_variants.mha_qkv_merged,
            "quantize_rows": quant.quantize_rows,
            "int8_gemm": quant.int8_gemm}


def counters() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def zero_counters() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0
    w = kernel_wrappers()["layernorm"]
    w.backward_launches = 0


def b_backward_launches() -> int:
    """Launches of B's backward kernel since :func:`zero_counters` (its
    wrapper counts them beside the forward's, on ``layernorm``)."""
    return kernel_wrappers()["layernorm"].backward_launches


def expected(**counts) -> dict:
    """A full counter dict: the given launches, 0 for every other kernel."""
    return {k: counts.get(k, 0) for k in KERNELS}


def profile_forward(torch, model, crops, pts) -> dict:
    """Device time of one forward by kernel, from ``torch.profiler``: the
    sum of every kernel's self device time, grouped (the port's kernels by
    name; cuDNN convolutions, GEMMs, the rest), the ten longest kernels, and
    the device-busy share of the profiled forward's wall time. Empty when
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        model(crops, pts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    # kernels only: an operator's self device time repeats its kernels'
    kernels = [e for e in events if "CUDA" in str(e.device_type)] or [
        e for e in events if not e.key.startswith("aten::")]
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in kernels]
    if not rows:
        return {}
    groups = {"D mha_kernel": "mha_kernel", "A attn_qkv": "attn_qkv_",
              "B ln_kernel": "ln_kernel", "B backward": "ln_bwd_",
              "E jbu_kernel": "jbu_kernel", "C edt": "edt"}
    out: dict = {k: 0.0 for k in groups}
    out.update(conv=0.0, gemm=0.0, other=0.0)
    for ms, key, _ in rows:
        name = next((g for g, pat in groups.items() if pat in key), None)
        low = key.lower()
        if name is None:  # implicit-GEMM convolutions name both
            name = ("conv" if "conv" in low or "fprop" in low
                    or "cudnn" in low
                    else "gemm" if "gemm" in low or "cutlass" in low
                    else "other")
        out[name] += ms
    total = sum(ms for ms, _, _ in rows)
    rows.sort(reverse=True)
    return {"device_ms": total, "wall_ms": wall_ms,
            "busy_share": total / wall_ms, "by_group_ms": out,
            "top": [[round(ms, 4), key[:90], n] for ms, key, n in rows[:10]]}


def learned_family(torch, name: str) -> dict:
    """Main paths 3-6: one learned-upsampler family (DINOv2-S/14 + LoftUp or
    JBU-FeatUp at FAMILY_SIZE², drawn from seed 0 and calibrated) through
    the card's forward against the CPU, the host protocol and the device
    loop, with exact launch counts on each path, and the split of one loop
    step."""
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.evaluation import (
        evaluate_dataset,
        evaluate_sample,
        latency_percentiles,
    )
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_torch.models.vit import init_params
    from isegprobe_torch.ops.resize import resize

    per_forward = FORWARD_LAUNCHES[name]
    size = (FAMILY_SIZE, FAMILY_SIZE)
    res: dict = {}
    cfg = dict(flagship_config(size), upsampler_cfg=UPSAMPLERS[name])
    model = init_params(iSegProbeModel(**cfg), seed=0).eval()
    res["classifier_bias"] = calibrate_classifier(
        torch, model, FAMILY_SIZE, FAMILY_POSITIVE_SHARE)
    cpu_model = iSegProbeModel(**cfg, device="cpu").eval()
    cpu_model.load_state_dict(model.state_dict())
    # the CPU forward of the first sample alone: it takes tens of seconds
    img_d, pts_d, logits, res["forward"] = forward_vs_cpu(
        torch, model, cpu_model, FAMILY_SIZE, per_forward, name, cpu_batch=1)
    del cpu_model
    if name == "loftup":
        res["bf16_forward"] = bf16_forward(torch, model, cfg, img_d, pts_d,
                                           logits, per_forward, name)[1]

    # main path: the host predictor answers NoC clicks
    predictor = Predictor(model, target_size=size, with_flip=True,
                          net_clicks_limit=20)
    evaluate_sample(*scene(10), predictor, max_iou_thr=2.0, max_clicks=1)
    click_s = time_clicks(predictor)
    sample_s: list = []
    zero_counters()
    all_ious, _ = evaluate_dataset(Scenes([scene(11)]), predictor,
                                   latencies=sample_s, max_iou_thr=0.95,
                                   max_clicks=3, callback=check_probs)
    host_launches = counters()
    n_clicks = sum(len(a) for a in all_ious)
    if host_launches != expected(**{k: v * n_clicks
                                    for k, v in per_forward.items()}):
        fail(f"{name}: host protocol launched {host_launches} for "
             f"{n_clicks} clicks")
    res["host"] = {"clicks": n_clicks, "launches": host_launches,
                   "ious": [[float(v) for v in a] for a in all_ious],
                   "per_click": latency_percentiles(click_s),
                   "per_click_protocol": latency_percentiles(sample_s)}
    print(f"{name} host", json.dumps(res["host"]))

    # main path: the batched on-device loop at B=FAMILY_BATCH
    loop_scenes = [scene(20 + i) for i in range(FAMILY_JOBS)]

    def evaluator(batch, target):
        return device_eval.make_device_evaluator(
            model, target_size=size, batch_size=batch,
            target_iou=target, net_clicks_limit=20,
            max_clicks=FAMILY_CLICKS)

    probe = device_eval.evaluate_dataset_device(
        evaluator(FAMILY_BATCH, 2.0), Scenes(loop_scenes))
    found = find_target(probe, FAMILY_CLICKS)
    # a drawn probe whose lanes never split runs every lane to the end
    target, stops = found or (2.0, [FAMILY_CLICKS] * len(loop_scenes))
    run = evaluator(FAMILY_BATCH, target)
    zero_counters()
    t0 = time.time()
    got = device_eval.evaluate_dataset_device(run, Scenes(loop_scenes))
    wall = time.time() - t0
    loop_launches = counters()
    want = expected(edt_row_envelope=run.steps,
                    **{k: v * run.steps for k, v in per_forward.items()})
    if loop_launches != want:
        fail(f"{name}: device loop launched {loop_launches} in {run.steps} "
             f"steps, expected {want}")
    lengths = [len(a) for a in got]
    if lengths != stops:
        fail(f"{name}: lanes stopped at {lengths}, expected {stops}")
    got1 = device_eval.evaluate_dataset_device(evaluator(1, target),
                                               Scenes(loop_scenes))
    err_b1 = same_trajectories(got, got1, LOOP_IOU_TOL,
                               f"{name}: B={FAMILY_BATCH} vs B=1")
    host_idx = sorted({int(np.argmin(lengths)), int(np.argmax(lengths))})
    host_pred = Predictor(model, target_size=size, with_flip=True,
                          net_clicks_limit=20)
    host = [evaluate_sample(*loop_scenes[i], host_pred, max_iou_thr=target,
                            pred_thr=0.49, max_clicks=FAMILY_CLICKS)[1]
            for i in host_idx]
    err_host = same_trajectories([got[i] for i in host_idx], host,
                                 LOOP_IOU_TOL, f"{name}: loop vs Predictor")
    res["device_loop"] = {
        "batch": FAMILY_BATCH, "jobs": FAMILY_JOBS, "target_iou": target,
        "target_splits_lanes": found is not None, "lengths": lengths,
        "steps": run.steps, "host_reads": run.host_reads,
        "launches": loop_launches, "wall_s": wall,
        "ms_per_step": 1e3 * wall / run.steps,
        "lane_clicks_per_s": sum(lengths) / wall,
        "ious": [[float(v) for v in a] for a in got],
        "max_iou_diff_vs_b1": err_b1, "host_compared": host_idx,
        "max_iou_diff_vs_host": err_host}
    print(f"{name} device_loop", json.dumps(
        {k: v for k, v in res["device_loop"].items() if k != "ious"}))

    chunk = first_chunk(torch, device_eval, loop_scenes, FAMILY_BATCH)
    if name == "jbu_featup":
        # no hidden syncs in this family's click either
        res["sync_check"] = sync_checked_run(torch, run, chunk,
                                             got[:FAMILY_BATCH], name)
        print(f"{name} sync_check", json.dumps(res["sync_check"]))
        res["bf16_loop"] = bf16_family_loop(torch, model, cfg, loop_scenes,
                                            target, per_forward, name,
                                            res["device_loop"])

    # the split of one loop step (forward at batch 2·B): backbone with the
    # click encoding, upsampler, head (with JBU's resize to the crop size)
    with torch.inference_mode():
        st = run._init_state(*chunk)
        sel, pts_full = run._select(st)
        crops, pts = run._crop_points(st["image"], st["prev"], sel["roi"],
                                      pts_full)
        image_n, prev = model.prepare_input(crops)

        def backbone():
            coords = model.get_coord_features(image_n, prev, pts)
            return model.backbone(image_n, model.embed_coords(coords))

        feats = backbone()
        hr = model.upsampler(feats, image_n)

        def head():
            f = hr
            if f.shape[1:3] != size:
                f = resize(f, size, "bilinear", align_corners=True)
            return model.head(f)

        slow = dict(reps=1, rounds=3, graph=False)
        split = {"batch": int(crops.shape[0]),
                 "backbone_ms": time_ms(torch, backbone, **slow)[0],
                 "upsampler_ms": time_ms(
                     torch, lambda: model.upsampler(feats, image_n),
                     **slow)[0],
                 "head_ms": time_ms(torch, head, **slow)[0],
                 "forward_ms": time_ms(torch, lambda: model(crops, pts),
                                       **slow)[0],
                 "loop_ms_per_step": res["device_loop"]["ms_per_step"]}
        split["profile"] = profile_forward(torch, model, crops, pts)
    print(f"{name} step_split", json.dumps(split))
    res["step_split"] = split
    res["path_launches"] = {f"{name}_host": host_launches,
                            f"{name}_loop": loop_launches}
    if "bf16_forward" in res:
        res["path_launches"][f"{name}_bf16_forward"] = expected(
            **res["bf16_forward"]["launches_per_forward"])
    if "bf16_loop" in res:
        res["path_launches"][f"{name}_bf16_loop"] = res["bf16_loop"][
            "launches"]
    return res


def bf16_family_loop(torch, model, cfg: dict, loop_scenes, target: float,
                     per_forward: dict, name: str, f32: dict) -> dict:
    """The family's device loop at B=FAMILY_BATCH in bf16 (params cast as
    evaluate.py casts them) on the f32 loop's scenes and target: every
    step 1 C plus one forward's launches, NoC@80/85/90 within
    JBU_BF16_NOC_TOL of the f32 loop's, the first click at which the two
    part (a click elsewhere, or an IoU more than LOOP_IOU_TOL away), ms a
    step beside the f32 loop's."""
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = (FAMILY_SIZE, FAMILY_SIZE)
    model16 = iSegProbeModel(**cfg).eval()
    model16.load_state_dict(model.state_dict())
    model16.to(torch.bfloat16)

    def evaluator(m):
        return device_eval.make_device_evaluator(
            m, target_size=size, batch_size=FAMILY_BATCH, target_iou=target,
            net_clicks_limit=20, max_clicks=FAMILY_CLICKS,
            record_clicks=True)

    clicks32: list = []
    ious32 = device_eval.evaluate_dataset_device(
        evaluator(model), Scenes(loop_scenes), clicks=clicks32)
    run16 = evaluator(model16)
    device_eval.evaluate_dataset_device(run16, Scenes(loop_scenes),
                                        clicks=[])  # constants to the card
    clicks16: list = []
    steps0 = run16.steps  # the evaluator counts its steps over its calls
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.time()
    ious16 = device_eval.evaluate_dataset_device(run16, Scenes(loop_scenes),
                                                 clicks=clicks16)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = counters()
    steps = run16.steps - steps0
    want = expected(edt_row_envelope=steps,
                    **{k: v * steps for k, v in per_forward.items()})
    if launches != want:
        fail(f"{name} bf16 loop launched {launches} in {steps} steps, "
             f"expected {want}")
    thrs = [0.80, 0.85, 0.90]
    noc32 = compute_noc_metric(ious32, thrs, FAMILY_CLICKS)[0]
    noc16 = compute_noc_metric(ious16, thrs, FAMILY_CLICKS)[0]
    gap = max(abs(a - b) for a, b in zip(noc16, noc32))
    parting = None
    for k, (a, b, ca, cb) in enumerate(zip(ious16, ious32, clicks16,
                                           clicks32)):
        for j in range(min(len(a), len(b))):
            if (np.asarray(ca[j]) != np.asarray(cb[j])).any() or \
                    abs(float(a[j]) - float(b[j])) > LOOP_IOU_TOL:
                if parting is None or j < parting["click"]:
                    parting = {"object": k, "click": j + 1}
                break
    rec = {"batch": FAMILY_BATCH, "jobs": len(loop_scenes),
           "target_iou": target, "steps": steps, "wall_s": wall,
           "ms_per_step": 1e3 * wall / steps,
           "f32_ms_per_step": f32["ms_per_step"], "noc_bf16": noc16,
           "noc_f32": noc32, "noc_gap": gap, "first_parting": parting,
           "lengths": [len(a) for a in ious16], "launches": launches}
    print(f"{name} bf16_loop", json.dumps(rec))
    if gap > JBU_BF16_NOC_TOL:
        fail(f"{name}: the bf16 loop's NoC {noc16} is {gap} from the f32 "
             f"loop's {noc32}")
    return rec


def against_fixture(ious, clicks, want_ious, want_n, want_clicks,
                    what: str, max_diverged: int) -> dict:
    """Hold per-object trajectories against the JAX package's (the
    fixture's): each object's IoUs within LOOP_IOU_TOL up to its first click
    that differs from JAX's in position or sign (or where one run stops and
    the other clicks on), all of them where none does; at most
    ``max_diverged`` objects may differ at all, each printed."""
    diverged, err = [], 0.0
    for i, (got_i, got_c) in enumerate(zip(ious, clicks)):
        n = int(want_n[i])
        want_c = [tuple(int(v) for v in c) for c in want_clicks[i, :n]]
        got_c = [tuple(int(v) for v in c) for c in got_c]
        k = next((j for j, (a, b) in enumerate(zip(got_c, want_c))
                  if a != b), None)
        if k is None and len(got_c) != n:
            k = min(len(got_c), n)
        upto = len(got_c) if k is None else k
        if upto:
            err = max(err, float(np.abs(np.asarray(got_i[:upto])
                                        - want_ious[i, :upto]).max()))
        if k is not None:
            diverged.append({"object": i, "click": k + 1,
                             "got": got_c[k] if k < len(got_c) else "stop",
                             "want": want_c[k] if k < n else "stop"})
    for d in diverged:
        print(f"{what}: object {d['object']} clicks differently from JAX at "
              f"click {d['click']}: {d['got']} (y, x, positive) here, "
              f"{d['want']} in JAX")
    if err > LOOP_IOU_TOL:
        fail(f"{what}: IoUs differ from JAX's by {err} > {LOOP_IOU_TOL} "
             f"before any click differs")
    if len(diverged) > max_diverged:
        fail(f"{what}: {len(diverged)} objects click differently from JAX "
             f"(at most {max_diverged} allowed)")
    return {"max_iou_diff_before_divergence": err, "diverged": diverged}


def host_against_fixture(torch, model, fx, key: str, m: int,
                         per_forward: dict, what: str) -> dict:
    """The f32 host protocol (``Predictor``, fixed-448 ZoomIn, flip, the
    trained protocol) on the fixture's first ``m`` objects, with exactly
    one forward's ``per_forward`` launches a click, held against the
    fixture's ``{key}_*`` JAX results as ``against_fixture`` holds them;
    p50 ms per click and per ``get_prediction``."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference.evaluation import (
        evaluate_sample,
        latency_percentiles,
    )
    from isegprobe_torch.inference.predictor import Predictor

    predictor = Predictor(model, target_size=(448, 448), with_flip=True,
                          net_clicks_limit=TRAINED_CLICKS)
    host_data = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, m))
    samples = [host_data.get_sample(i) for i in range(len(host_data))]
    evaluate_sample(samples[0].image, samples[0].gt_mask(0), predictor,
                    max_iou_thr=2.0, max_clicks=1)  # warm-up
    click_s = time_clicks(predictor)
    per_click, host_ious, host_clicks = [], [], []
    zero_counters()
    for sample in samples:
        t0 = time.time()
        cl, ious, _ = evaluate_sample(
            sample.image, sample.gt_mask(0), predictor,
            max_iou_thr=TRAINED_TARGET, pred_thr=TRAINED_THRESH,
            max_clicks=TRAINED_CLICKS)
        per_click.append((time.time() - t0) / len(ious))
        host_ious.append(ious)
        host_clicks.append([(*c.coords, int(c.is_positive)) for c in cl])
    launches = counters()
    n_clicks = sum(len(a) for a in host_ious)
    if launches != expected(**{k: v * n_clicks
                               for k, v in per_forward.items()}):
        fail(f"{what} host protocol launched {launches} for {n_clicks} "
             "clicks")
    host = {"objects": m, "clicks": n_clicks, "launches": launches,
            "per_get_prediction": latency_percentiles(click_s),
            "per_click_protocol": latency_percentiles(per_click),
            **against_fixture(host_ious, host_clicks, fx[f"{key}_ious"][:m],
                              fx[f"{key}_n"][:m], fx[f"{key}_clicks"][:m],
                              f"{what} f32 host protocol",
                              TRAINED_MAX_DIVERGED)}
    print(f"{what}_host", json.dumps(host))
    return host


def trained_phase(torch, cuda) -> dict:
    """Main paths of the trained probes: the 160-epoch flagship checkpoint
    and the 448² LoftUp one, loaded through ``isegprobe_torch.evaluate.
    load_model_for_eval`` (frozen parts rebuilt from PRNGKey(0) in numpy)
    and held against the JAX package's results on the stored Synthetic
    scenes (``isegprobe_torch/fixtures/synthetic2026_50.npz``): the f32
    device loop on every object, the host protocol on the first
    TRAINED_HOST_OBJECTS, the bf16 loops as a report, and LoftUp's f32 loop
    on the fixture's objects, then timed on the first
    TRAINED_LOFTUP_TIMED_OBJECTS. Returns the
    records, the path launches and the kernel checks at the paths'
    shapes, and under ``shared`` (not a record) the f32 and bf16 models
    and the lockstep loops' trajectories, clicks and records, which phase
    11e runs the job queue beside."""
    import warnings

    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.models.upsamplers.loftup import LN_EPS
    from isegprobe_torch.ops import attention, edt, layernorm
    from isegprobe_torch.scripts import bench_edt

    F = torch.nn.functional
    res: dict = {}
    shared: dict = {}
    fx = dict(np.load(SYNTHETIC_FIXTURE))
    data = SceneDataset(SYNTHETIC_FIXTURE)
    n_obj = data.n_objects
    # kernels A-D at the shapes these paths give them: 224² scenes pad to
    # 256², so C's rows are 258 wide; the bf16 B=16 loop runs forwards of
    # 32 crops; LoftUp's loops of 2 and 4 lanes forwards of 4 and 8, whose
    # LayerNorms run 404 wide on a slab's 64 × 448 query rows and the 32²
    # key rows, 203 wide on the stem's 68 × 448 rows, 384 in the
    # ChannelNorm
    side = TRAINED_SCENE + 2
    fwd32 = 2 * 2 * TRAINED_BATCH
    checks = [edt_case(torch, edt, bench_edt.column_input(
        "clicker", (b, 2, side, side), cuda, seed=50 + b), "clicker")
        for b in (TRAINED_BATCH, 2 * TRAINED_BATCH)]
    checks += cross_attention_case(torch, F, attention,
                                   2 * TRAINED_LOFTUP_OBJECTS, 64 * 448, 1024,
                                   4, 101, "float32", seed=52)
    checks += attention_case(torch, F, attention, fwd32, 1025, 6, 64,
                             "bfloat16", seed=53)
    checks.append(layernorm_case(torch, F, layernorm, (fwd32, 1025), 384,
                                 "bfloat16", seed=54))
    seed = 55
    for b in (2 * TRAINED_LOFTUP_OBJECTS, 2 * FAMILY_BATCH):
        for rows, d in (((64 * 448,), 404), ((1024,), 404),
                        ((68, 448), 203), ((1024,), 384)):
            checks.append(layernorm_case(torch, F, layernorm, (b, *rows), d,
                                         "float32", seed=seed, eps=LN_EPS))
            seed += 1

    def evaluator(model, batch, max_clicks=TRAINED_CLICKS,
                  record_clicks=False):
        return device_eval.make_device_evaluator(
            model, target_size=(448, 448), batch_size=batch,
            max_clicks=max_clicks, net_clicks_limit=max_clicks,
            pred_thr=TRAINED_THRESH, target_iou=TRAINED_TARGET,
            record_clicks=record_clicks)

    def noc_of(all_ious, max_clicks=TRAINED_CLICKS):
        return compute_noc_metric(all_ious, [0.8, 0.85, 0.9],
                                  max_clicks)[0]

    want_noc = [float(v) for v in fx["flagship_noc"]]
    models = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.time()
        models[dtype], info = eval_load(
            torch, TRAINED_CKPTS["flagship"], getattr(torch, dtype))
        res[f"load_{dtype}"] = {"load_s": time.time() - t0,
                                "init_tree_s": info["init_seconds"],
                                "frozen_params": info["frozen_params"]}
        print(f"trained flagship {dtype}: init tree built in "
              f"{info['init_seconds']:.2f} s, {info['frozen_params']:,} "
              f"frozen parameters, loaded in {time.time() - t0:.2f} s")
        if info["frozen_params"] != TRAINED_FROZEN["flagship"]:
            fail(f"trained flagship: {info['frozen_params']} frozen "
                 f"parameters, expected {TRAINED_FROZEN['flagship']}")

    # the device loops: f32 at B=8, held against JAX; bf16 at B=8 and 16
    paths, loops = {}, []
    for dtype, batch in (("float32", TRAINED_BATCH),
                         ("bfloat16", TRAINED_BATCH),
                         ("bfloat16", 2 * TRAINED_BATCH)):
        model = models[dtype]
        device_eval.evaluate_dataset_device(  # warm-up: per-device constants
            evaluator(model, batch, max_clicks=1), data)
        gated = dtype == "float32"  # only the f32 loop is held against JAX
        run = evaluator(model, batch, record_clicks=gated)
        clicks = [] if gated else None
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.time()
        got = device_eval.evaluate_dataset_device(run, data, clicks=clicks)
        wall = time.time() - t0
        launches = counters()
        want = expected(**{k: v * run.steps for k, v in PER_STEP.items()})
        if launches != want:
            fail(f"trained {dtype} B={batch} loop launched {launches} in "
                 f"{run.steps} steps, expected {want}")
        if len(got) != n_obj or not all(
                np.isfinite(a).all() and 1 <= len(a) <= TRAINED_CLICKS
                for a in got):
            fail(f"trained {dtype} B={batch} loop: bad trajectories")
        n_clicks = sum(len(a) for a in got)
        rec = {"dtype": dtype, "batch": batch, "objects": len(got),
               "steps": run.steps, "clicks": n_clicks, "wall_s": wall,
               "ms_per_step": 1e3 * wall / run.steps,
               "lane_clicks_per_s": n_clicks / wall, "noc": noc_of(got),
               "jax_cpu_noc": want_noc, "launches": launches,
               "records_clicks": gated}
        if dtype == "bfloat16":
            gap = max(abs(a - b) for a, b in zip(rec["noc"], want_noc))
            rec["noc_gap_to_jax_f32"] = gap
            if gap > TRAINED_BF16_NOC_TOL:
                fail(f"trained bf16 B={batch} NoC@80/85/90 {rec['noc']} "
                     f"differ from JAX's f32 {want_noc} by {gap} > "
                     f"{TRAINED_BF16_NOC_TOL}")
        if gated:
            rec.update(against_fixture(
                got, clicks, fx["flagship_ious"], fx["flagship_n"],
                fx["flagship_clicks"], "trained f32 device loop",
                TRAINED_MAX_DIVERGED))
            gap = max(abs(a - b) for a, b in zip(rec["noc"], want_noc))
            if gap > TRAINED_NOC_TOL:
                fail(f"trained f32 NoC@80/85/90 {rec['noc']} differ from "
                     f"JAX's {want_noc} by {gap} > {TRAINED_NOC_TOL}")
        print("trained_loop", json.dumps(
            {k: v for k, v in rec.items() if k != "diverged"}))
        print(f"trained flagship {dtype} B={batch}: NoC@80/85/90 "
              + " / ".join(f"{v:.4f}" for v in rec["noc"]) + " (JAX f32 "
              "on the CPU: " + " / ".join(f"{v:.4f}" for v in want_noc)
              + f"), {rec['lane_clicks_per_s']:.2f} lane-clicks/s, "
              f"{rec['ms_per_step']:.3f} ms/step")
        loops.append(rec)
        paths[f"trained_loop_{dtype}_b{batch}"] = launches
        # phase 11e runs the job queue beside these lockstep loops
        shared[dtype, batch] = (got, clicks, dict(
            rec, **share_of_steps(n_clicks, run.steps, batch)))
    res["device_loops"] = loops

    # the host protocol, f32, on the first objects
    res["host"] = host_against_fixture(
        torch, models["float32"], fx, "flagship", TRAINED_HOST_OBJECTS,
        FORWARD_LAUNCHES["flagship"], "trained")
    print(f"trained host protocol: p50 "
          f"{res['host']['per_click_protocol']['p50_ms']:.3f} ms per click, "
          f"{res['host']['per_get_prediction']['p50_ms']:.3f} ms per "
          "get_prediction")
    paths["trained_host"] = res["host"]["launches"]
    shared["models"] = models

    # LoftUp: its configured upsampler_path is missing, so it must warn and
    # keep the PRNGKey(0) upsampler, as the JAX package's evaluation did
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.time()
        model, info = eval_load(torch, TRAINED_CKPTS["loftup"],
                                torch.float32)
        load_s = time.time() - t0
    warned = [str(w.message) for w in caught
              if "upsampler_path" in str(w.message)]
    print(f"trained LoftUp: init tree built in {info['init_seconds']:.2f} s, "
          f"{info['frozen_params']:,} frozen parameters; warned: {warned}")
    if not warned:
        fail("trained LoftUp: no warning for its missing upsampler_path")
    if info["frozen_params"] != TRAINED_FROZEN["loftup"]:
        fail(f"trained LoftUp: {info['frozen_params']} frozen parameters, "
             f"expected {TRAINED_FROZEN['loftup']}")
    per_step = dict(edt_row_envelope=1, **FORWARD_LAUNCHES["loftup"])

    def loftup_loop(dataset, batch, max_clicks, clicks):
        run = evaluator(model, batch, max_clicks=max_clicks,
                        record_clicks=clicks is not None)
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.time()
        got = device_eval.evaluate_dataset_device(run, dataset,
                                                  clicks=clicks)
        wall = time.time() - t0
        launches = counters()
        want = expected(**{k: v * run.steps for k, v in per_step.items()})
        if launches != want:
            fail(f"trained LoftUp B={batch} loop launched {launches} in "
                 f"{run.steps} steps, expected {want}")
        return got, {"objects": len(got), "batch": batch,
                     "max_clicks": max_clicks, "steps": run.steps,
                     "clicks": sum(len(a) for a in got), "wall_s": wall,
                     "ms_per_step": 1e3 * wall / run.steps,
                     "launches": launches}

    # against JAX on the fixture's objects, then timed on the first ones
    m = TRAINED_LOFTUP_OBJECTS
    clicks = []
    got, loftup = loftup_loop(SceneDataset(SYNTHETIC_FIXTURE,
                                           objects=slice(0, m)),
                              m, TRAINED_LOFTUP_CLICKS, clicks)
    loftup.update(ious=[[float(v) for v in a] for a in got],
                  load_s=load_s, init_tree_s=info["init_seconds"],
                  frozen_params=info["frozen_params"],
                  **against_fixture(got, clicks, fx["loftup_ious"],
                                    fx["loftup_n"], fx["loftup_clicks"],
                                    "trained LoftUp f32 device loop", 0))
    print("trained_loftup", json.dumps(loftup))
    got, timed = loftup_loop(
        SceneDataset(SYNTHETIC_FIXTURE,
                     objects=slice(0, TRAINED_LOFTUP_TIMED_OBJECTS)),
        FAMILY_BATCH, FAMILY_CLICKS, None)
    if len(got) != TRAINED_LOFTUP_TIMED_OBJECTS or not all(
            np.isfinite(a).all() and 1 <= len(a) <= FAMILY_CLICKS
            for a in got):
        fail("trained LoftUp timed loop: bad trajectories")
    timed.update(lane_clicks_per_s=timed["clicks"] / timed["wall_s"],
                 noc=noc_of(got, FAMILY_CLICKS))
    print("trained_loftup_timed", json.dumps(timed))
    print(f"trained LoftUp f32 B={FAMILY_BATCH}, {len(got)} objects, <= "
          f"{FAMILY_CLICKS} clicks: {timed['ms_per_step']:.1f} ms/step, "
          f"{timed['lane_clicks_per_s']:.2f} lane-clicks/s, NoC@80/85/90 "
          + " / ".join(f"{v:.4f}" for v in timed["noc"]))
    res["loftup"] = loftup
    res["loftup_timed"] = timed
    paths["trained_loftup_loop"] = loftup["launches"]
    paths["trained_loftup_timed"] = timed["launches"]
    res["path_launches"] = paths
    res["checks"] = checks
    res["shared"] = shared
    return res


def drawn_family(torch, name: str, head: str | None = None) -> dict:
    """One drawn probe of ``synthetic_config(name)`` at 448² (seed 0,
    calibrated): its card forward against the CPU with exact launches,
    then, unless ``head`` swaps in another head (a forward only), a short
    f32 device loop of FAMILY_BATCH lanes on the drawn scenes with every
    step's launches checked (with the trunk cache, the click encoder every
    step plus the trunk on each chunk's first click and each recompute,
    and the trajectories equal to an uncached loop's)."""
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.models.probe_model import (
        iSegProbeModel,
        synthetic_config,
    )
    from isegprobe_torch.models.vit import init_params

    size = (448, 448)
    per_forward = OTHER_FORWARD_LAUNCHES[name]
    cfg = synthetic_config(name, size)
    what = name
    if head is not None:
        cfg["head_cfg"] = dict(type=head, params=dict(
            in_channels=384, num_classes=1,
            **({"num_layers": 2} if head == "simple_conv" else {})))
        what = f"{name} {head} head"
    model = init_params(iSegProbeModel(**cfg), seed=0).eval()
    res = {"classifier_bias": calibrate_classifier(
        torch, model, size[0], FAMILY_POSITIVE_SHARE)}
    cpu_model = iSegProbeModel(**cfg, device="cpu").eval()
    cpu_model.load_state_dict(model.state_dict())
    res["forward"] = forward_vs_cpu(torch, model, cpu_model, size[0],
                                    per_forward, what, cpu_batch=1)[3]
    del cpu_model
    res["path_launches"] = {
        f"{what.replace(' ', '_')}_forward": expected(**per_forward)}
    if head is not None:
        return res

    scenes = Scenes([scene(20 + i) for i in range(FAMILY_JOBS)])

    def evaluator(trunk_cache="auto"):
        return device_eval.make_device_evaluator(
            model, target_size=size, batch_size=FAMILY_BATCH,
            target_iou=2.0, net_clicks_limit=20, max_clicks=OTHER_CLICKS,
            trunk_cache=trunk_cache)

    run = evaluator()
    zero_counters()
    t0 = time.time()
    got = device_eval.evaluate_dataset_device(run, scenes)
    wall = time.time() - t0
    launches = counters()
    if run.use_cache:
        chunks = -(-FAMILY_JOBS // FAMILY_BATCH)
        trunks = chunks + run.trunk_recomputes
        want = expected(
            edt_row_envelope=run.steps,
            mha_qkv=SIMPLEVIT_LAUNCHES["mha_qkv"] * run.steps + 12 * trunks,
            layernorm=SIMPLEVIT_LAUNCHES["layernorm"] * run.steps
            + 25 * trunks)
    else:
        want = expected(edt_row_envelope=run.steps,
                        **{k: v * run.steps for k, v in per_forward.items()})
    if launches != want:
        fail(f"{name}: device loop launched {launches} in {run.steps} steps "
             f"(trunk recomputed {run.trunk_recomputes} times), expected "
             f"{want}")
    if [len(a) for a in got] != [OTHER_CLICKS] * FAMILY_JOBS or not all(
            np.isfinite(a).all() for a in got):
        fail(f"{name}: bad trajectories {got}")
    loop = {"batch": FAMILY_BATCH, "jobs": FAMILY_JOBS,
            "clicks": OTHER_CLICKS, "steps": run.steps, "wall_s": wall,
            "ms_per_step": 1e3 * wall / run.steps,
            "lane_clicks_per_s": sum(len(a) for a in got) / wall,
            "trunk_cache": run.use_cache, "launches": launches,
            "ious": [[float(v) for v in a] for a in got]}
    if name == "dinov2_simplevit":
        if not run.use_cache:
            fail("dinov2_simplevit: trunk_cache='auto' did not pick the "
                 "cache for after_backbone injection")
        uncached = device_eval.evaluate_dataset_device(evaluator("off"),
                                                       scenes)
        loop.update(trunk_recomputes=run.trunk_recomputes,
                    max_iou_diff_vs_uncached=same_trajectories(
                        got, uncached, CACHE_TOL,
                        f"{name}: cached vs uncached trunk"))
    print(f"{name} device_loop", json.dumps(
        {k: v for k, v in loop.items() if k != "ious"}))
    res["device_loop"] = loop
    res["path_launches"][f"{name}_loop"] = launches
    return res


def other_backbones_phase(torch) -> dict:
    """Main paths 17-28, the other backbones the paper probes: the trained
    MaskCLIP probe (``synthetic_maskclip_noup_160ep.ckpt`` through
    ``isegprobe_torch.evaluate.load_model_for_eval``, its CLIP tower rebuilt
    from PRNGKey(0)) held against the JAX package's results stored in
    ``isegprobe_torch/fixtures/synthetic_maskclip.npz``: the f32 device
    loop at B=8 on all 78 objects (as the flagship's: IoUs, clicks, NoC),
    the bf16 loops at B=8 and 16 (NoC within MASKCLIP_BF16_NOC_TOL of JAX's
    f32) and the host protocol on the first objects; then the drawn
    DINO ViT key probe, DINOv2 + SimpleViT (trunk cache) and DINOv2 + LiFT
    (``drawn_family``) and the linear and simple_conv heads on the key
    probe. Kernels A and B are checked and timed at these paths' shapes.
    Returns the records, the path launches and the kernel checks."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.models.featurizers.maskclip import LN_EPS
    from isegprobe_torch.ops import attention, layernorm

    F = torch.nn.functional
    res: dict = {}
    paths: dict = {}
    # kernels A and B at the shapes these paths give them. Forward batches
    # (flip TTA doubles the lanes): 2 for the host protocol and the drawn
    # probes' card forward, 2·TRAINED_BATCH for the MaskCLIP loops at B=8
    # (f32 and bf16) and twice that for bf16 B=16, 2·FAMILY_BATCH for the
    # drawn loops (f32). Token rows: MaskCLIP's 785 (12 heads; LayerNorms
    # 768 wide, eps 1e-5), the DINO trunk's 785 (6 heads), SimpleViT's 1024
    # (8 heads; LayerNorms over its 14·14·3 patches and 384-wide tokens),
    # the DINOv2 trunk's 1025 (6 heads; at batch 2 it is checked with the
    # flagship). The batch-16 rows of SimpleViT in bf16 and of the DINO
    # trunk are the shapes of a B=8 loop of these probes.
    fwd = 2 * TRAINED_BATCH
    fam = 2 * FAMILY_BATCH
    f32, bf16 = "float32", "bfloat16"
    attn_shapes = [(2, 785, 12, f32), (fwd, 785, 12, f32),
                   (fwd, 785, 12, bf16), (2 * fwd, 785, 12, bf16),
                   (fwd, 1024, 8, f32), (fwd, 1024, 8, bf16),
                   (fwd, 785, 6, f32),
                   (2, 785, 6, f32), (fam, 785, 6, f32),
                   (2, 1024, 8, f32), (fam, 1024, 8, f32),
                   (fam, 1025, 6, f32)]
    ln_shapes = [(2, 785, 768, LN_EPS, f32), (fwd, 785, 768, LN_EPS, f32),
                 (fwd, 785, 768, LN_EPS, bf16),
                 (2 * fwd, 785, 768, LN_EPS, bf16),
                 (fwd, 785, 384, 1e-6, f32), (fwd, 1024, 588, 1e-6, f32),
                 (fwd, 1024, 384, 1e-6, f32)]
    ln_shapes += [(b, rows, d, 1e-6, f32) for b in (2, fam)
                  for rows, d in ((785, 384), (1024, 588), (1024, 384))]
    ln_shapes.append((fam, 1025, 384, 1e-6, f32))
    checks = []
    seed = 70
    for b, n, heads, dtype in attn_shapes:
        checks += attention_case(torch, F, attention, b, n, heads, 64, dtype,
                                 seed=seed)
        seed += 1
    for b, rows, d, eps, dtype in ln_shapes:
        checks.append(dict(layernorm_case(torch, F, layernorm, (b, rows), d,
                                          dtype, seed=seed, eps=eps),
                           eps=eps))
        seed += 1

    fx = dict(np.load(MASKCLIP_FIXTURE))
    data = SceneDataset(SYNTHETIC_FIXTURE)
    k = int(fx["maskclip_objects"])
    if k != data.n_objects:
        fail(f"{MASKCLIP_FIXTURE.name} holds {k} objects, not all "
             f"{data.n_objects}")
    want_noc = [float(v) for v in fx["maskclip_noc"]]
    per_step = dict(edt_row_envelope=1,
                    **OTHER_FORWARD_LAUNCHES["maskclip_noup"])
    models = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.time()
        models[dtype], info = eval_load(
            torch, TRAINED_CKPTS["maskclip"], getattr(torch, dtype))
        res[f"load_{dtype}"] = {"load_s": time.time() - t0,
                                "init_tree_s": info["init_seconds"],
                                "frozen_params": info["frozen_params"]}
        print(f"trained MaskCLIP {dtype}: init tree built in "
              f"{info['init_seconds']:.2f} s, {info['frozen_params']:,} "
              f"frozen parameters, loaded in {time.time() - t0:.2f} s")
        if info["frozen_params"] != TRAINED_FROZEN["maskclip"]:
            fail(f"trained MaskCLIP: {info['frozen_params']} frozen "
                 f"parameters, expected {TRAINED_FROZEN['maskclip']}")

    def noc_of(all_ious):
        return compute_noc_metric(all_ious, [0.8, 0.85, 0.9],
                                  TRAINED_CLICKS)[0]

    def clicks_to(ious, counts=None, thr=0.9):
        if counts is not None:
            ious = [row[:int(n)] for row, n in zip(ious, counts)]
        return [next((j + 1 for j, v in enumerate(a) if v >= thr),
                     TRAINED_CLICKS) for a in ious]

    def loop(dtype, batch, data, record):
        model = models[dtype]
        device_eval.evaluate_dataset_device(  # warm-up: per-device constants
            device_eval.make_device_evaluator(
                model, target_size=(448, 448), batch_size=batch,
                max_clicks=1, net_clicks_limit=TRAINED_CLICKS),
            SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, batch)))
        run = device_eval.make_device_evaluator(
            model, target_size=(448, 448), batch_size=batch,
            max_clicks=TRAINED_CLICKS, net_clicks_limit=TRAINED_CLICKS,
            pred_thr=TRAINED_THRESH, target_iou=TRAINED_TARGET,
            record_clicks=record)
        clicks = [] if record else None
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.time()
        got = device_eval.evaluate_dataset_device(run, data, clicks=clicks)
        wall = time.time() - t0
        launches = counters()
        want = expected(**{kk: v * run.steps for kk, v in per_step.items()})
        what = f"trained MaskCLIP {dtype} B={batch}"
        if launches != want:
            fail(f"{what} loop launched {launches} in {run.steps} steps, "
                 f"expected {want}")
        if len(got) != data.n_objects or not all(
                np.isfinite(a).all() and 1 <= len(a) <= TRAINED_CLICKS
                for a in got):
            fail(f"{what} loop: bad trajectories")
        n_clicks = sum(len(a) for a in got)
        rec = {"dtype": dtype, "batch": batch, "objects": len(got),
               "steps": run.steps, "clicks": n_clicks, "wall_s": wall,
               "ms_per_step": 1e3 * wall / run.steps,
               "lane_clicks_per_s": n_clicks / wall, "noc": noc_of(got),
               "launches": launches}
        return got, clicks, rec

    loops = []
    for dtype, batch in (("float32", TRAINED_BATCH),
                         ("bfloat16", TRAINED_BATCH),
                         ("bfloat16", 2 * TRAINED_BATCH)):
        gated = dtype == "float32"
        got, clicks, rec = loop(dtype, batch, data, gated)
        rec["jax_cpu_noc"] = want_noc
        gap = max(abs(a - b) for a, b in zip(rec["noc"], want_noc))
        rec["noc_gap_to_jax_f32"] = gap
        # the objects whose clicks to 90% IoU (20 when never reached) are
        # not JAX's: (object, JAX's count, this loop's)
        rec["clicks_to_90_differ"] = [
            (i, a, b) for i, (a, b) in enumerate(zip(
                clicks_to(fx["maskclip_ious"], fx["maskclip_n"]),
                clicks_to(got))) if a != b]
        if gated:
            rec.update(against_fixture(
                got, clicks, fx["maskclip_ious"], fx["maskclip_n"],
                fx["maskclip_clicks"], "trained MaskCLIP f32 device loop",
                TRAINED_MAX_DIVERGED))
            if gap > TRAINED_NOC_TOL:
                fail(f"trained MaskCLIP f32 NoC@80/85/90 {rec['noc']} differ "
                     f"from JAX's {want_noc} by {gap} > {TRAINED_NOC_TOL}")
        elif gap > MASKCLIP_BF16_NOC_TOL:
            fail(f"trained MaskCLIP bf16 B={batch} NoC@80/85/90 "
                 f"{rec['noc']} differ from JAX's f32 {want_noc} by {gap} > "
                 f"{MASKCLIP_BF16_NOC_TOL}")
        print("maskclip_loop", json.dumps(
            {kk: v for kk, v in rec.items() if kk != "diverged"}))
        print(f"trained MaskCLIP {dtype} B={batch}, {k} objects: "
              "NoC@80/85/90 " + " / ".join(f"{v:.4f}" for v in rec["noc"])
              + " (JAX f32 on the CPU: "
              + " / ".join(f"{v:.4f}" for v in want_noc)
              + f"), {rec['lane_clicks_per_s']:.2f} lane-clicks/s, "
              f"{rec['ms_per_step']:.3f} ms/step")
        loops.append(rec)
        paths[f"maskclip_loop_{dtype}_b{batch}"] = rec["launches"]
    res["device_loops"] = loops

    # the host protocol, f32, on the first objects
    res["host"] = host_against_fixture(
        torch, models["float32"], fx, "maskclip", TRAINED_HOST_OBJECTS,
        OTHER_FORWARD_LAUNCHES["maskclip_noup"], "maskclip")
    paths["maskclip_host"] = res["host"]["launches"]
    del models

    for name in ("vit_noup", "dinov2_simplevit", "dinov2_lift"):
        res[name] = drawn_family(torch, name)
        paths.update(res[name]["path_launches"])
    for head in ("linear", "simple_conv"):
        res[f"vit_noup_{head}"] = drawn_family(torch, "vit_noup", head)
        paths.update(res[f"vit_noup_{head}"]["path_launches"])
    res["path_launches"] = paths
    res["checks"] = checks
    return res


def share_of_steps(useful: int, steps: int, batch: int) -> dict:
    """Useful clicks, lane-steps and the share of lane-steps that click."""
    return {"useful_clicks": useful, "lane_steps": steps * batch,
            "clicking_share": useful / (steps * batch)}


def timed_loop(torch, run_loop, what: str, batch: int, steps_of,
               want_per_step=None) -> tuple:
    """Run ``run_loop()`` (-> trajectories) with every counter set to 0
    just before and read just after. Returns the trajectories and a record:
    wall time, ms a step, lane-clicks/s, the clicking share of lane-steps
    and the launches, held against ``want_per_step(steps)`` if given."""
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.time()
    got = run_loop()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = counters()
    steps = steps_of()
    if want_per_step is not None and launches != want_per_step(steps):
        fail(f"{what} launched {launches} in {steps} steps, expected "
             f"{want_per_step(steps)}")
    if not all(np.isfinite(a).all() and 1 <= len(a) <= TRAINED_CLICKS
               for a in got):
        fail(f"{what}: bad trajectories")
    useful = sum(len(a) for a in got)
    rec = {"batch": batch, "steps": steps, "wall_s": wall,
           "ms_per_step": 1e3 * wall / steps,
           "lane_clicks_per_s": useful / wall, "launches": launches,
           **share_of_steps(useful, steps, batch)}
    return got, rec


def same_clicks(got, got_clicks, want, want_clicks, tol: float,
                what: str) -> float:
    """Fail unless every object stops at the same click, clicks at the same
    pixels with the same sign and has IoUs within ``tol``; returns the
    largest IoU difference."""
    err = same_trajectories(got, want, tol, what)
    for i, (a, b) in enumerate(zip(got_clicks, want_clicks)):
        a = [tuple(int(v) for v in c) for c in a]
        b = [tuple(int(v) for v in c) for c in b]
        if a != b:
            fail(f"{what}: object {i} clicks {a}, expected {b}")
    return err


def ritm_and_refill_phase(torch, cuda, shared: dict) -> dict:
    """Main paths 29-36: the RITM adaptive protocol and continuous batching
    on the trained flagship (phase 11e of the module docstring), the job
    queue beside phase 11b's lockstep loops and models (``shared``).
    Returns the records, the path launches and the kernel checks."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference import adaptive_eval, device_eval
    from isegprobe_torch.inference.evaluation import (
        evaluate_sample,
        latency_percentiles,
    )
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.inference.brs import get_predictor
    from isegprobe_torch.models.probe_model import (
        iSegProbeModel,
        synthetic_config,
    )
    from isegprobe_torch.models.vit import canvas_token_mask, init_params
    from isegprobe_torch.ops import attention, edt, layernorm
    from isegprobe_torch.scripts import bench_edt

    F = torch.nn.functional
    f32, bf16 = "float32", "bfloat16"
    res: dict = {}
    paths: dict = {}
    fx = dict(np.load(RITM_FIXTURE))
    fixed_fx = dict(np.load(SYNTHETIC_FIXTURE))
    data = SceneDataset(SYNTHETIC_FIXTURE)
    n_obj = data.n_objects
    if int(fx["ritm_objects"]) != n_obj:
        fail(f"{RITM_FIXTURE.name} holds {int(fx['ritm_objects'])} "
             f"objects, not all {n_obj}")
    want_noc = [float(v) for v in fx["ritm_noc"]]
    fwd = 2 * TRAINED_BATCH

    # (f) kernels B and C at the adaptive loop's shapes: B on the masked
    # forward's 842 token rows at forward batch 16, C on the clicker's
    # padded frames (the frame's, not the canvas's: the clicker works on
    # the full frame); A beside the plain masked attention at its shape
    checks = [layernorm_case(torch, F, layernorm, (fwd, RITM_TOKENS), 384,
                             dtype, seed=90 + i)
              for i, dtype in enumerate((f32, bf16))]
    side = TRAINED_SCENE + 2
    checks.append(edt_case(torch, edt, bench_edt.column_input(
        "clicker", (TRAINED_BATCH, 2, side, side), cuda, seed=92),
        "clicker"))
    checks += attention_case(torch, F, attention, fwd, RITM_TOKENS, 6, 64,
                             f32, seed=93)
    for c in checks:
        c["adaptive"] = True
    g = torch.Generator(device="cuda").manual_seed(94)
    qkv = torch.randn((fwd, RITM_TOKENS, 1152), generator=g, device="cuda")
    grids = torch.tensor([[29, 29], [29, 20], [16, 16], [25, 29]] * 4,
                         device="cuda")
    mask = canvas_token_mask((29, 29), grids)
    masked_ms, method = time_ms(
        torch, lambda: attention.mha_qkv(qkv, 6, key_mask=mask))
    res["masked_attention"] = {
        "shape": list(qkv.shape), "dtype": f32, "ms": masked_ms,
        "timing": method, "kernel_a_unmasked_ms": checks[-1]["ms"],
        "bound": _bound(4.0 * fwd * 6 * RITM_TOKENS ** 2 * 64,
                        4.0 * qkv.numel() * 4 / 3, f32,
                        exps=fwd * 6 * RITM_TOKENS ** 2)}
    print("ritm masked_attention", json.dumps(res["masked_attention"]))
    del qkv

    # the models: the adaptive protocol's (eval_ritm: the pos-embed at its
    # pretraining grid) and phase 11b's fixed-crop ones (resized to 448²)
    models = {("fixed", dtype): m for dtype, m in shared["models"].items()}
    for dtype in (f32, bf16):
        models["ritm", dtype], info = eval_load(
            torch, TRAINED_CKPTS["flagship"], getattr(torch, dtype),
            eval_ritm=True)
        if info["frozen_params"] != TRAINED_FROZEN["flagship"]:
            fail(f"trained flagship (eval_ritm): {info['frozen_params']} "
                 "frozen parameters")

    def noc_of(all_ious):
        return [float(v) for v in compute_noc_metric(
            all_ious, [0.8, 0.85, 0.9], TRAINED_CLICKS)[0]]

    protocol = dict(max_clicks=TRAINED_CLICKS,
                    net_clicks_limit=TRAINED_CLICKS, pred_thr=TRAINED_THRESH,
                    target_iou=TRAINED_TARGET)

    def adaptive(dtype, batch, group=False, record=False, **kw):
        return adaptive_eval.make_adaptive_evaluator(
            models["ritm", dtype], RITM_TARGET, batch_size=batch,
            group_api=group, skip_clicks=RITM_SKIP_CLICKS,
            record_clicks=record, **dict(protocol, **kw))

    def fixed(dtype, batch, group=False, record=False, **kw):
        return device_eval.make_device_evaluator(
            models["fixed", dtype], target_size=(448, 448),
            batch_size=batch, group_api=group, record_clicks=record,
            **dict(protocol, **kw))

    def warm(run):  # per-device constants, outside the counted runs
        device_eval.evaluate_dataset_device(
            run, SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, 1)))

    def adaptive_launches(steps):
        return expected(**{k: v * steps
                           for k, v in ADAPTIVE_PER_STEP.items()})

    def fixed_launches(steps):
        return expected(**{k: v * steps for k, v in PER_STEP.items()})

    loops: dict = {}

    def report(name, rec):
        loops[name] = rec
        print(f"ritm_loop {name}", json.dumps(
            {k: v for k, v in rec.items() if k != "diverged"}))
        print(f"{name}: {rec['ms_per_step']:.3f} ms a step, "
              f"{rec['lane_clicks_per_s']:.2f} lane-clicks/s, "
              f"{rec['useful_clicks']} clicks in {rec['lane_steps']} "
              f"lane-steps ({100 * rec['clicking_share']:.1f}% clicking)"
              + (f", NoC {rec['noc']}" if "noc" in rec else ""))

    # (a) the adaptive f32 loop at B=8 against JAX's adaptive results
    warm(adaptive(f32, 1, max_clicks=2))
    run = adaptive(f32, TRAINED_BATCH, record=True)
    clicks_a: list = []
    got_a, rec = timed_loop(
        torch, lambda: device_eval.evaluate_dataset_device(
            run, data, clicks=clicks_a),
        "adaptive f32 B=8 loop", TRAINED_BATCH, lambda: run.steps,
        adaptive_launches)
    rec.update(noc=noc_of(got_a), jax_cpu_noc=want_noc, **against_fixture(
        got_a, clicks_a, fx["ritm_ious"], fx["ritm_n"], fx["ritm_clicks"],
        "adaptive f32 device loop", TRAINED_MAX_DIVERGED))
    gap = max(abs(a - b) for a, b in zip(rec["noc"], want_noc))
    if gap > TRAINED_NOC_TOL:
        fail(f"adaptive f32 NoC@80/85/90 {rec['noc']} differ from JAX's "
             f"{want_noc} by {gap} > {TRAINED_NOC_TOL}")
    report("adaptive_f32_b8", rec)
    paths["ritm_adaptive_f32_b8"] = rec["launches"]

    # (b) the adaptive bf16 loop at B=8
    warm(adaptive(bf16, 1, max_clicks=2))
    run = adaptive(bf16, TRAINED_BATCH)
    got, rec = timed_loop(
        torch, lambda: device_eval.evaluate_dataset_device(run, data),
        "adaptive bf16 B=8 loop", TRAINED_BATCH, lambda: run.steps,
        adaptive_launches)
    rec.update(noc=noc_of(got), jax_cpu_noc=want_noc)
    rec["noc_gap_to_jax_f32"] = max(abs(a - b)
                                    for a, b in zip(rec["noc"], want_noc))
    if rec["noc_gap_to_jax_f32"] > RITM_BF16_NOC_TOL:
        fail(f"adaptive bf16 NoC@80/85/90 {rec['noc']} differ from JAX's "
             f"f32 {want_noc} by more than {RITM_BF16_NOC_TOL}")
    report("adaptive_bf16_b8", rec)
    paths["ritm_adaptive_bf16_b8"] = rec["launches"]

    # (c) the host transform chain on the first objects against (a)
    chain = get_predictor(
        models["ritm", f32], with_flip=True,
        zoom_in_params={"skip_clicks": RITM_SKIP_CLICKS,
                        "target_size": RITM_TARGET},
        predictor_params={"net_clicks_limit": TRAINED_CLICKS})
    m = TRAINED_HOST_OBJECTS
    first = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, m))
    samples = [first.get_sample(i) for i in range(m)]
    evaluate_sample(samples[0].image, samples[0].gt_mask(0), chain,
                    max_iou_thr=2.0, max_clicks=2)  # warm-up
    per_click, host_ious, host_clicks = [], [], []
    zero_counters()
    for sample in samples:
        t0 = time.time()
        cl, ious, _ = evaluate_sample(
            sample.image, sample.gt_mask(0), chain,
            max_iou_thr=TRAINED_TARGET, pred_thr=TRAINED_THRESH,
            max_clicks=TRAINED_CLICKS)
        per_click.append((time.time() - t0) / len(ious))
        host_ious.append(ious)
        host_clicks.append([(*c.coords, int(c.is_positive)) for c in cl])
    launches = counters()
    n_clicks = sum(len(a) for a in host_ious)
    if launches != expected(**{k: v * n_clicks for k, v in
                               FORWARD_LAUNCHES["flagship"].items()}):
        fail(f"host chain launched {launches} for {n_clicks} clicks")
    # the chain against JAX's chain (the same protocol); against the device
    # loop a report: the chain averages the flip's probabilities, the loop
    # its logits, and JAX's own pair parts by 0.0201 on these objects
    res["host_chain"] = {
        "objects": m, "clicks": n_clicks, "launches": launches,
        "per_click_protocol": latency_percentiles(per_click),
        **against_fixture(host_ious, host_clicks, fx["ritm_host_ious"],
                          fx["ritm_host_n"], fx["ritm_host_clicks"],
                          "host chain", TRAINED_MAX_DIVERGED),
        "vs_device_loop": {
            "same_counts": [len(a) for a in host_ious]
            == [len(a) for a in got_a[:m]],
            "objects_clicking_differently": sum(
                [tuple(int(v) for v in c) for c in a]
                != [tuple(int(v) for v in c) for c in b]
                for a, b in zip(host_clicks, clicks_a[:m])),
            "max_iou_diff": max(
                float(np.abs(np.asarray(a[:len(b)])
                             - np.asarray(b[:len(a)])).max())
                for a, b in zip(host_ious, got_a[:m]))}}
    print("ritm host_chain", json.dumps(res["host_chain"]))
    paths["ritm_host_chain"] = launches

    # (d) the fixed-crop loop through the job queue, beside phase 11b's
    # lockstep loops of the same models, batch and protocol
    fixed_noc = [float(v) for v in fixed_fx["flagship_noc"]]
    for dtype, batch in ((f32, TRAINED_BATCH), (bf16, 2 * TRAINED_BATCH)):
        gated = dtype == f32
        got_l, lock_clicks, rec_l = shared[dtype, batch]
        ev = fixed(dtype, batch, group=True, record=gated)
        stats: dict = {}
        ref_clicks = [] if gated else None
        steps0 = ev.steps
        got_r, rec_r = timed_loop(
            torch, lambda: device_eval.evaluate_dataset_group(
                ev, data, stats=stats, clicks=ref_clicks),
            f"fixed {dtype} B={batch} refill", batch,
            lambda: ev.steps - steps0, fixed_launches)
        rec_r["stats"] = stats
        if stats["useful_clicks"] != rec_r["useful_clicks"] or \
                stats["steps"] != rec_r["steps"]:
            fail(f"refill stats {stats} disagree with the run {rec_r}")
        rec_r["noc"] = noc_of(got_r)
        if gated:
            rec_r["max_iou_diff_vs_lockstep"] = same_clicks(
                got_r, ref_clicks, got_l, lock_clicks, REFILL_TOL,
                f"fixed {dtype} B={batch} refill against lockstep")
            if rec_r["noc"] != fixed_noc:
                fail(f"fixed f32 refill NoC {rec_r['noc']} != the fixture's "
                     f"{fixed_noc}")
        report(f"fixed_{dtype}_b{batch}_lockstep (phase 11b)", rec_l)
        report(f"fixed_{dtype}_b{batch}_refill", rec_r)
        paths[f"refill_fixed_{dtype}_b{batch}"] = rec_r["launches"]

    # (e) the adaptive loop through the job queue, against (a)
    ev = adaptive(f32, TRAINED_BATCH, group=True, record=True)
    stats, ref_clicks = {}, []
    got, rec = timed_loop(
        torch, lambda: device_eval.evaluate_dataset_group(
            ev, data, stats=stats, clicks=ref_clicks),
        "adaptive f32 B=8 refill", TRAINED_BATCH, lambda: ev.steps,
        adaptive_launches)
    rec.update(stats=stats, noc=noc_of(got),
               max_iou_diff_vs_lockstep=same_clicks(
                   got, ref_clicks, got_a, clicks_a, REFILL_TOL,
                   "adaptive f32 refill against lockstep"))
    report("adaptive_f32_b8_refill", rec)
    paths["refill_adaptive_f32_b8"] = rec["launches"]
    res["loops"] = loops

    # (f) the masked forward's device time by kernel group, at forward
    # batch 16 on canvases of four valid rects
    model = models["ritm", f32]
    vhw = torch.tensor([[406, 406], [406, 290], [224, 224], [350, 406]] * 4,
                       device="cuda")
    crops = torch.rand((fwd, 406, 406, 4), generator=g, device="cuda")
    pts = torch.full((fwd, 2 * TRAINED_CLICKS, 3), -1.0, device="cuda")
    pts[:, 0] = torch.tensor([100.0, 100.0, 0.0], device="cuda")
    with torch.no_grad():
        res["masked_forward_profile"] = profile_forward(
            torch, lambda c, p: model.forward_masked(c, p, vhw), crops, pts)
    print("ritm masked_forward_profile",
          json.dumps(res["masked_forward_profile"]))
    del crops, models

    # (g) the drawn SimpleViT probe (trunk cache) through the job queue
    cfg = synthetic_config("dinov2_simplevit", (FAMILY_SIZE, FAMILY_SIZE))
    sv = init_params(iSegProbeModel(**cfg), seed=0).eval()
    calibrate_classifier(torch, sv, FAMILY_SIZE, FAMILY_POSITIVE_SHARE)
    scenes = Scenes([scene(30 + i) for i in range(REFILL_FAMILY_JOBS)])

    def sv_run(target, group=False):
        return device_eval.make_device_evaluator(
            sv, target_size=(FAMILY_SIZE, FAMILY_SIZE),
            batch_size=FAMILY_BATCH, target_iou=target, group_api=group,
            net_clicks_limit=20, max_clicks=OTHER_CLICKS, record_clicks=True)

    first = device_eval.evaluate_dataset_device(sv_run(2.0), scenes)
    target, _ = pick_target(first, OTHER_CLICKS)
    run = sv_run(target)
    lock_clicks: list = []
    got_l, rec_l = timed_loop(
        torch, lambda: device_eval.evaluate_dataset_device(
            run, scenes, clicks=lock_clicks),
        "SimpleViT lockstep", FAMILY_BATCH, lambda: run.steps)
    ev = sv_run(target, group=True)
    stats, ref_clicks = {}, []
    got_r, rec_r = timed_loop(
        torch, lambda: device_eval.evaluate_dataset_group(
            ev, scenes, stats=stats, clicks=ref_clicks),
        "SimpleViT refill", FAMILY_BATCH, lambda: ev.steps)
    recomputes = ev.protocol.trunk_recomputes
    want = expected(
        edt_row_envelope=rec_r["steps"],
        mha_qkv=SIMPLEVIT_LAUNCHES["mha_qkv"] * rec_r["steps"]
        + 12 * recomputes,
        layernorm=SIMPLEVIT_LAUNCHES["layernorm"] * rec_r["steps"]
        + 25 * recomputes)
    if rec_r["launches"] != want:
        fail(f"SimpleViT refill launched {rec_r['launches']}, expected "
             f"{want} ({rec_r['steps']} steps, {recomputes} trunks)")
    if recomputes < 2:
        fail("SimpleViT refill recomputed the trunk on no refill")
    rec_r.update(stats=stats, target_iou=target, trunk_recomputes=recomputes,
                 max_iou_diff_vs_lockstep=same_clicks(
                     got_r, ref_clicks, got_l, lock_clicks, REFILL_TOL,
                     "SimpleViT refill against lockstep"))
    res["simplevit_refill"] = {"lockstep": rec_l, "refill": rec_r}
    print("ritm simplevit_refill", json.dumps(res["simplevit_refill"]))
    paths["refill_simplevit_b4"] = rec_r["launches"]
    res["path_launches"] = paths
    res["checks"] = checks
    return res


def digest(tree, prefix="") -> dict:
    """Per leaf of a flax-named param tree: sum, L2 norm and the first 16
    values (NaN past a smaller leaf's end), float64 (the fixture's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(digest(v, f"{prefix}{k}/"))
        else:
            a = np.asarray(v, np.float64).ravel()
            first = np.full(16, np.nan)
            first[:min(16, a.size)] = a[:16]
            out[prefix + k] = np.concatenate(
                [[a.sum(), np.sqrt((a * a).sum())], first])
    return out


def readback_error(torch, model, ckpt: Path, size: int) -> float:
    """The checkpoint read back as evaluate.py reads it
    (``load_model_for_eval`` at ``size``²): the largest difference of its
    logits from ``model``'s on a seeded image with a positive and a
    negative click, over their scale."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LoftUp's missing upsampler_path
        loaded, _ = eval_load(torch, ckpt, torch.float32, (size, size))
    g = torch.Generator(device="cuda").manual_seed(75)
    image = torch.rand((1, size, size, 4), generator=g, device="cuda")
    pts = torch.full((1, 48, 3), -1.0, device="cuda")
    pts[0, 0] = torch.tensor([size * 200 // 518, size * 300 // 518, 0.0])
    pts[0, 24] = torch.tensor([size * 50 // 518, size * 60 // 518, 1.0])
    with torch.no_grad():
        want = model(image, pts)["instances"]
        got = loaded(image, pts)["instances"]
    return float((got - want).abs().max()) / float(want.abs().max())


def step_checker(name: str, per_forward: dict, per_step: dict,
                 recompute: dict | None = None):
    """A trainer's ``on_step``: every step launches exactly (1 + num_iters)
    × ``per_forward`` + num_iters C (+ ``recompute``, the backward's, on a
    training step), recorded by kind in ``per_step`` with B's backward
    launches (``layernorm_bwd``)."""
    def on_step(kind, index, num_iters):
        got = counters()
        extra = (recompute or {}) if kind == "train" else {}
        want = expected(**{k: v * (1 + num_iters) + extra.get(k, 0)
                           for k, v in per_forward.items()},
                        edt_row_envelope=num_iters)
        if got != want:
            fail(f"{name} {kind} step {index} (num_iters {num_iters}) "
                 f"launched {got}, expected {want}")
        per_step.setdefault(kind, []).append(
            {**got, "layernorm_bwd": b_backward_launches()})
        zero_counters()

    return on_step


def cli_epoch(torch, name: str, per_forward: dict, readback: int | None,
              argv=(), recompute: dict | None = None,
              exp_path: str | None = None) -> tuple:
    """One epoch with validation through the trainer of ``python -m
    isegprobe_torch.train model=synthetic_<name>`` (or ``model=<name>``
    for an ``sbd_*`` script; ``argv`` appended):
    every step launches exactly (1 + num_iters) × ``per_forward`` +
    num_iters C (+ ``recompute`` a training step), the losses are finite,
    the checkpoint is float32 and, read back at ``readback``² (and the
    trainer's model put back to float32 compute), gives the trainer's
    logits within TRAIN_READBACK_TOL of their scale (None: not read
    back). The run directory
    goes under ``exp_path`` (default: a temporary directory removed after
    the read-back). Returns (trainer, record)."""
    import contextlib
    import tempfile

    from isegprobe_torch import train as train_cli
    from isegprobe_torch.utils.serialization import load_checkpoint

    per_step = {"train": [], "val": []}
    on_step = step_checker(name, per_forward, per_step, recompute)

    with (contextlib.nullcontext(exp_path) if exp_path
          else tempfile.TemporaryDirectory()) as tmp:
        model = name if name.startswith("sbd_") else f"synthetic_{name}"
        cli = [f"model={model}", "training_params.epochs=1",
               f"dataloader.workers={TRAIN_WORKERS}", f"exp_path={tmp}",
               *argv]
        cfg = train_cli.parse_args(cli)
        t0 = time.time()
        trainer = build(cli, on_step=on_step)
        build_s = time.time() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.time()
        trainer.run(1, validation=True)
        wall = time.time() - t0
        trainer.shutdown()
        peak = torch.cuda.max_memory_allocated()
        st = trainer.stats
        steps = cfg["epoch_len"] // cfg["dataloader.batch_size"]
        if len(st["num_iters"]) != steps:
            fail(f"{name}: the epoch ran {len(st['num_iters'])} steps, "
                 f"expected {steps}")
        losses = st["loss"]
        if not np.isfinite(losses).all():
            fail(f"{name}: non-finite training losses {losses}")
        ckpt = Path(trainer.cfg.CHECKPOINTS_PATH) / "last_checkpoint.ckpt"
        saved, config, _ = load_checkpoint(ckpt)
        if any(np.asarray(v).dtype != np.float32 for v in
               _leaves(saved)) or "dtype" in config["params"]:
            fail(f"{name}: the checkpoint is not float32 or records a "
                 "dtype")
        trainer.model.set_compute_dtype(None)
        err = (0.0 if readback is None else
               readback_error(torch, trainer.model, ckpt, readback))
        if not err <= TRAIN_READBACK_TOL:
            fail(f"{name}: the checkpoint read back gives logits {err} of "
                 f"the logit scale from the trainer's model")
    wait = np.asarray(st["data_wait_s"]) * 1e3
    return trainer, {
        "model": name, "steps": steps, "workers": TRAIN_WORKERS,
        "wall_s": wall, "build_s": build_s,
        "ms_per_step_median": 1e3 * float(np.median(st["step_wall_s"])),
        "device_ms_per_step_median": float(np.median(st["step_device_ms"])),
        "data_wait_ms_median": float(np.median(wait)),
        "data_wait_ms_mean": float(wait.mean()),
        "peak_memory_mb": peak / 2**20, "num_iters": st["num_iters"],
        "loss_first10": float(np.mean(losses[:10])),
        "loss_last10": float(np.mean(losses[-10:])),
        "val_loss": getattr(trainer, "val_loss", None),
        "val_steps": len(per_step["val"]),
        "launches": {kind: {k: sum(c[k] for c in per_step[kind])
                            for k in KERNELS} for kind in per_step},
        "b_backward_launches": sum(c["layernorm_bwd"]
                                   for c in per_step["train"]),
        "readback_size": readback, "readback_rel_err": err}


def step_vs_jax(torch, name: str, batch_np: dict, want_losses,
                digest_names, digests, per_forward: dict, argv=(),
                loss_rtol: float = TRAIN_LOSS_RTOL,
                flips: int = TRAIN_FLIPS,
                b_backward: int | None = None) -> tuple:
    """The full-width 224² step of ``models/synthetic/<name>.py`` (or of
    an ``sbd_*`` script) through the command line's trainer (``argv``
    appended), from ``init_tree(
    config, 0)`` on the fixture's items ``batch_np`` at num_iters=0, twice:
    exactly 2 × ``per_forward`` launches, the losses within ``loss_rtol``
    of JAX's and every trainable leaf's digest within
    tests/test_torch_training.py's tolerances (with ``flips`` sign flips),
    the click encoder's gradient non-zero; B's backward launches counted
    (exactly 2 × ``b_backward`` when given). Returns (trainer, batch on the
    card, record)."""
    t0 = time.time()
    model = name if name.startswith("sbd_") else f"synthetic_{name}"
    trainer = build([f"model={model}", "dataloader.workers=0",
                     f"exp_path={scratch()}", *argv])
    init_s = time.time() - t0
    batch = trainer._upload({k: batch_np[k] for k in ("images", "points",
                                                      "instances")})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counters()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    losses = [float(trainer._step(batch, 0)[0])]
    ev[1].record()
    losses.append(float(trainer._step(batch, 0)[0]))
    ev[2].record()
    torch.cuda.synchronize()
    step_launches = counters()
    if step_launches != expected(**{k: 2 * v for k, v in
                                    per_forward.items()}):
        fail(f"{name}: two train steps launched {step_launches}")
    b_bwd = b_backward_launches()
    if b_backward is not None and b_bwd != 2 * b_backward:
        fail(f"{name}: two train steps launched B's backward {b_bwd} "
             f"times, expected {2 * b_backward}")
    grad_norm = float(torch.stack([
        p.grad.norm() for n, p in trainer.model.named_parameters()
        if n.startswith("embed_coords.") and p.grad is not None]).norm())
    if not grad_norm > 0:
        fail(f"{name}: the click encoder's gradient is zero")
    dig = digest(trainer.full_params(("embed_coords", "head")))
    loss_err = float(np.max(np.abs(np.asarray(losses) / want_losses - 1)))
    digest_err = {}
    for key, want in zip(digest_names, digests):
        got = dig[str(key)]
        tol_sum = TRAIN_DIGEST_RTOL * want[1] + flips * 4.4 * TRAIN_LR
        e_sum = float(np.abs(got[:2] - want[:2]).max())
        e_first = float(np.nanmax(np.abs(got[2:] - want[2:])))
        digest_err[str(key)] = {"sum_l2": e_sum, "sum_l2_tol": tol_sum,
                                "first16": e_first}
        if e_sum > tol_sum or e_first > TRAIN_DIGEST_ATOL or not \
                np.array_equal(np.isnan(got), np.isnan(want)):
            fail(f"{name}: trainable leaf {key} after two steps differs "
                 f"from JAX's: {digest_err[str(key)]}")
    if loss_err > loss_rtol:
        fail(f"{name}: train step losses {losses} differ from JAX's "
             f"{list(want_losses)} by {loss_err} > {loss_rtol}")
    return trainer, batch, {
        "model": name, "batch": int(batch["images"].shape[0]),
        "losses": losses, "jax_cpu_losses": [float(v) for v in want_losses],
        "loss_rel_err": loss_err, "digests": digest_err,
        "init_tree_s": init_s, "launches": step_launches,
        "b_backward_launches": b_bwd,
        "step_ms": [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])],
        "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
        "step_peak_mb": (torch.cuda.max_memory_allocated() - base) / 2**20,
        "click_encoder_grad_norm": grad_norm}


def training_phase(torch) -> dict:
    """Main paths of training (``isegprobe_torch.train``): (a) kernels A
    and B under autograd at the train step's shapes; (b) the Synthetic
    training items built without OpenCV against the JAX items of
    ``isegprobe_torch/fixtures/synthetic_train_step.npz``; (c) the
    full-width step from ``init_tree(config, 0)`` on that batch against
    JAX's loss and trainable leaves after two Adam steps; (d) an epoch of
    96 items through the command line's trainer, with validation, every
    step's launches checked, and the checkpoint read back by
    ``isegprobe_torch.evaluate.load_model_for_eval``. Returns the records,
    the path launches and the kernel checks at the step's shapes."""
    from isegprobe_torch import train as train_cli
    from isegprobe_torch.ops import attention, edt, layernorm
    from isegprobe_torch.scripts import bench_edt

    F = torch.nn.functional
    res: dict = {}
    fx = dict(np.load(TRAIN_FIXTURE))
    b, n_tok = TRAIN_BATCH, (TRAIN_CROP // 14) ** 2 + 1

    # (a) A and B under autograd, and forward-checked at the step's shapes
    checks = attention_case(torch, F, attention, b, n_tok, 6, 64, "float32",
                            seed=70)
    checks.append(layernorm_case(torch, F, layernorm, (b, n_tok), 384,
                                 "float32", seed=71))
    checks.append(edt_case(torch, edt, bench_edt.column_input(
        "clicker", (b, 2, TRAIN_CROP + 2, TRAIN_CROP + 2), torch.device(
            "cuda"), seed=72), "clicker"))
    grads = [autograd_case(torch, F, "mha_qkv", (b, n_tok, 1152), 73,
                           reps=10),
             autograd_case(torch, F, "layernorm", (b, n_tok, 384), 74,
                           reps=10)]
    for g in grads:
        print("train_autograd", json.dumps(g))
    if not all(g["ok"] for g in grads):
        fail(f"a kernel under autograd disagrees: {grads}")
    res["autograd"] = grads
    # B's backward alone at the step's shape (dx alone first: the kernels
    # line reads its record)
    checks += [c for g in grads for c in g.get("backward", [])]

    # (b) the data layer without OpenCV against the JAX items
    trainset, _ = train_cli.synthetic_datasets()
    t0 = time.time()
    items = [trainset.get_item(int(p), int(s))
             for p, s in zip(fx["positions"], fx["seeds"])]
    build_s = time.time() - t0
    exact, worst = 0, {"grey_levels": 0, "pixel_share": 0.0}
    for i, item in enumerate(items):
        for key in ("points", "instances"):
            if not np.array_equal(item[key], fx[key][i]):
                fail(f"training item {i}: {key} differ from the JAX item")
        diff = np.abs(item["images"].astype(int) - fx["images"][i])
        share = float((diff > 0).mean())
        worst = {"grey_levels": max(worst["grey_levels"], int(diff.max())),
                 "pixel_share": max(worst["pixel_share"], share)}
        exact += int(diff.max() == 0)
    data = {"items": len(items), "exact": exact, "worst": worst,
            "build_ms_per_item": 1e3 * build_s / len(items),
            "image_tol": TRAIN_IMAGE_TOL}
    print("train_data", json.dumps(data))
    print(f"training items: {exact} of {len(items)} equal to the JAX items "
          f"exactly (masks and points equal in all); "
          f"{data['build_ms_per_item']:.1f} ms an item, one thread")
    if (worst["grey_levels"] > TRAIN_IMAGE_TOL["grey_levels"]
            or worst["pixel_share"] > TRAIN_IMAGE_TOL["pixel_share"]):
        fail(f"training images differ from the JAX items by {worst}")
    res["data"] = data

    # (c) the full-width step against JAX's, from init_tree(config, 0)
    trainer, batch, step = step_vs_jax(
        torch, "dinov2_noup", fx, fx["losses"], fx["digest_names"],
        fx["digests"], FORWARD_LAUNCHES["flagship"],
        b_backward=FLAGSHIP_B_BACKWARD)
    step_launches = step["launches"]
    print("train_step_vs_jax", json.dumps(step))
    print(f"full-width train step: losses {step['losses']} (JAX on the CPU "
          f"{step['jax_cpu_losses']}), max rel err "
          f"{step['loss_rel_err']:.2e}")
    res["step_vs_jax"] = step
    # where a step's time goes: one step with two simulated clicks under
    # torch.profiler (device time by kernel group, device-busy share)
    trainer._step(batch, 2)  # warm-up of the clicker's constants
    prof = profile_forward(torch, lambda *_: trainer._step(batch, 2), None,
                           None)
    print("train_step_profile", json.dumps(prof))
    res["step_profile"] = prof
    trainer.shutdown()
    del trainer

    # (d) one epoch through the command line's trainer, with validation
    _, epoch = cli_epoch(torch, "dinov2_noup",
                         FORWARD_LAUNCHES["flagship"], TRAIN_READBACK,
                         [f"epoch_len={TRAIN_STEPS * TRAIN_BATCH}"])
    if epoch["steps"] != TRAIN_STEPS:
        fail(f"the epoch ran {epoch['steps']} steps, expected {TRAIN_STEPS}")
    if epoch["b_backward_launches"] != FLAGSHIP_B_BACKWARD * TRAIN_STEPS:
        fail(f"the epoch launched B's backward "
             f"{epoch['b_backward_launches']} times, expected "
             f"{FLAGSHIP_B_BACKWARD * TRAIN_STEPS}")
    launches = epoch["launches"]
    print("train_epoch", json.dumps(epoch))
    print(f"training epoch: {TRAIN_STEPS} steps in {epoch['wall_s']:.2f} s, "
          f"median {epoch['ms_per_step_median']:.2f} ms a step (device "
          f"{epoch['device_ms_per_step_median']:.2f} ms), data wait "
          f"median {epoch['data_wait_ms_median']:.2f} ms; loss first 10 "
          f"{epoch['loss_first10']:.4f}, last 10 "
          f"{epoch['loss_last10']:.4f}; checkpoint read back within "
          f"{epoch['readback_rel_err']:.2e} of the logit scale")
    res["epoch"] = epoch
    res["path_launches"] = {
        "train_step_vs_jax": step_launches,
        "train_epoch": launches["train"],
        "train_validation": launches["val"]}
    res["backward_launches"] = {
        "train_step_vs_jax": step["b_backward_launches"],
        "train_epoch": epoch["b_backward_launches"]}
    res["checks"] = checks + grads
    return res


def peak_mb(torch, fn) -> float:
    """Device memory ``fn`` allocates at its peak beyond what was
    allocated before it, in MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def autograd_case(torch, F, name: str, shape, seed: int,
                  reps: int = 1, dtype: str = "float32", real=None,
                  eps: float = 1e-6, b_affine: bool = False) -> dict:
    """Kernel A, B, D or E under autograd at a training shape, in ``dtype``
    (bf16: the inputs that mixed-precision training gives the kernel in
    bf16, B's weight and bias and E's scalars float32): the forward with
    grad equals the no-grad kernel output bitwise with one launch, and the
    plain version's within the dtype's tolerance (E's scaled by max |hr|,
    as in :func:`jbu_case`): the check that holds the kernel at this shape;
    every input's gradient (qkv; x, weight, bias; q, k, v; hr, proj, temp,
    sigma) equals autograd through the plain version within the dtype's
    GRAD_TOL of its scale. The backward of A, D and E is the plain
    version's VJP by design, so there that gate holds the Function's
    plumbing (which input gets which gradient, in which dtype). B's
    backward is a kernel (``csrc/layernorm.cu:iseg_layernorm_bwd``): its
    gradients are also held against its plain version ``_ln_plain_bwd``
    within GRAD_TOL, it launches twice here (x, weight and bias need
    gradients), and ``bench_layernorm.backward_case`` checks it alone with
    dx alone (one launch) and with all three (two; dweight and dbias
    bitwise over two runs), timed by :func:`time_ms` (a CUDA graph)
    beside its bound (:func:`_bound`) and
    ``aten.native_layer_norm_backward``: the case the path takes, dx alone
    or with ``b_affine`` all three (``real``: statistics over the first
    ``real`` channels, the rest zeros, as LoftUp's padded layout; ``eps``
    B's). Forward + backward
    timed (eager, CUDA events, ``reps`` calls a round) beside the plain
    version's and the library's (a yardstick: SDPA for A and D,
    ``F.layer_norm`` for B), each with its peak memory; the bound of the
    forward + backward's work at the inputs' widths."""
    from isegprobe_torch.ops import attention, jbu, layernorm
    from isegprobe_torch.scripts import bench_layernorm

    tdt = getattr(torch, dtype)
    size = tdt.itemsize
    g = torch.Generator(device="cuda").manual_seed(seed)
    library, exps, op_dtype = None, 0.0, dtype
    if name == "mha_qkv":
        b, n, three_c = shape
        heads, dh = three_c // 3 // 64, 64
        inputs = [torch.randn(shape, generator=g, device="cuda").to(tdt)]

        def kernel(*ts):
            return attention.mha_qkv(ts[0], heads)

        def plain(*ts):
            return attention._mha_qkv_plain(ts[0], heads, dh**-0.5)

        def library(qkv):
            q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(
                2, 0, 3, 1, 4).unbind(0)
            return F.scaled_dot_product_attention(
                q, k, v, scale=dh**-0.5).transpose(1, 2).reshape(b, n, -1)

        # forward 2 products, backward 5 (QK^T again, dV, dP, dQ, dK); the
        # exps twice; qkv, dO read, O and d qkv written
        ops = 14.0 * b * heads * n * n * dh
        exps = 2.0 * b * heads * n * n
        nbytes = size * 8 * (three_c // 3) * b * n
    elif name == "layernorm":
        d = shape[-1]
        inputs = [(torch.randn(shape, generator=g, device="cuda") * 3
                   + 1).to(tdt),
                  torch.randn(d, generator=g, device="cuda") * 0.5 + 1,
                  torch.randn(d, generator=g, device="cuda")]
        if real is not None:
            for t in inputs:
                t[..., real:] = 0

        def kernel(*ts):
            return layernorm.layernorm(*ts, eps, real)

        def plain(*ts):
            return layernorm._ln_plain(*ts, eps, real)

        def library(x, w, bias):
            return F.layer_norm(x, (d,), w.to(x.dtype), bias.to(x.dtype),
                                eps)

        if real is not None:
            library = None  # no call takes statistics over part of a row

        # x, dy read, y and dx written; computed in f32
        rows = int(np.prod(shape[:-1]))
        ops, nbytes, op_dtype = 16.0 * rows * d, size * 4 * rows * d, \
            "float32"
    elif name == "mha":
        (b, nq, heads, dh), nk = shape[0], shape[1][1]
        inputs = [torch.randn(s, generator=g, device="cuda").to(tdt)
                  for s in ((b, nq, heads, dh), (b, nk, heads, dh),
                            (b, nk, heads, dh))]
        scale = dh**-0.5

        def kernel(*ts):
            return attention.mha(*ts, scale)

        def plain(*ts):
            return attention._mha_plain(*ts, scale)

        def library(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                scale=scale).transpose(1, 2)

        # as A's; q, k, v, dO read, O and the three gradients written
        ops = 14.0 * b * heads * nq * nk * dh
        exps = 2.0 * b * heads * nq * nk
        nbytes = size * 4 * (nq + nk) * b * heads * dh
    else:
        b, h, w, c = shape
        inputs = [torch.randn((b, h, w, c), generator=g,
                              device="cuda").to(tdt),
                  (torch.randn((b, h, w, 32), generator=g, device="cuda")
                   * 0.3).to(tdt), torch.full((), 0.5, device="cuda"),
                  torch.full((), 0.8, device="cuda")]

        def kernel(*ts):
            return jbu.jbu_filter(*ts)

        plain = jbu._jbu_plain
        px = b * h * w
        # the forward's 49-tap dots and weighted sums, and about twice that
        # backward (the weighted sum's two products, the dots' two), in
        # f32; hr and proj read, out, d out, d hr and d proj once each
        ops, op_dtype = 3 * 2.0 * jbu.NTAP * (32 + c) * px, "float32"
        nbytes = size * (4 * c + 2 * 32) * px
    wrapper = kernel_wrappers()[name]
    with torch.no_grad():
        ref = kernel(*inputs)
        want = plain(*inputs)
    ts = [t.clone().requires_grad_(True) for t in inputs]
    before = wrapper.launches
    out = kernel(*ts)
    launched = wrapper.launches - before
    bitwise = bool(torch.equal(out.detach(), ref))
    forward = compare(torch, out.detach(), want, dtype,
                      float(inputs[0].float().abs().max())
                      if name == "jbu_filter" else 1.0)
    del ref, want
    cot = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
    bwd_before = layernorm.layernorm.backward_launches
    out.backward(cot)
    bwd_launched = layernorm.layernorm.backward_launches - bwd_before
    del out
    refs = [t.clone().requires_grad_(True) for t in inputs]
    plain(*refs).backward(cot)
    dtypes_ok = all(t.grad.dtype == t.dtype for t in ts)

    def rel(got, want):
        return float((got.float() - want.float()).abs().max()) / max(
            float(want.float().abs().max()), 1e-30)

    errs = [rel(t.grad, r.grad) for t, r in zip(ts, refs)]
    ok = (bitwise and forward["ok"] and launched == 1 and dtypes_ok
          and max(errs) <= GRAD_TOL[dtype])
    extra: dict = {}
    if name == "layernorm":
        closed = layernorm._ln_plain_bwd(*(t.detach() for t in inputs[:2]),
                                         cot, eps, real)
        extra["grad_rel_err_vs_closed_form"] = [
            rel(t.grad, c) for t, c in zip(ts, closed)]
        extra["backward_launches"] = bwd_launched
        extra["backward"] = [bench_layernorm.backward_case(
            f"{name}_{'dx' if needs == bench_layernorm.DX else 'all'}",
            shape, dtype, "float32", real, eps, needs, seed,
            torch.device("cuda"), tol=GRAD_TOL, bound=_bound,
            timer=(lambda fn: time_ms(torch, fn)[0])
            if (needs == bench_layernorm.ALL) == b_affine else None)
            for needs in (bench_layernorm.DX, bench_layernorm.ALL)]
        del closed
        ok = (ok and bwd_launched == 2
              and max(extra["grad_rel_err_vs_closed_form"]) <= GRAD_TOL[dtype]
              and all(c["ok"] for c in extra["backward"]))
    elif bwd_launched:
        ok = False  # only B's backward is a kernel
    del ts, refs

    def fwd_bwd(fn):
        xs = [t.detach().requires_grad_(True) for t in inputs]
        fn(*xs).backward(cot)

    rec = {"kernel": name, "shape": list(shape), "dtype": dtype,
           "autograd": True, "forward_bitwise": bitwise,
           "forward_vs_plain": {k: v for k, v in forward.items() if k != "ok"},
           "max_abs_err": forward["max_abs_err"],
           "launches_per_forward": launched, "grad_rel_err": errs,
           "grad_dtypes_ok": dtypes_ok, "grad_tol": GRAD_TOL[dtype],
           **({"real": real, "eps": eps} if name == "layernorm" else {}),
           **extra, "ok": ok, **_bound(ops, nbytes, op_dtype, exps=exps)}
    for key, fn in (("fwd_bwd", kernel), ("plain_fwd_bwd", plain),
                    ("library_fwd_bwd", library)):
        if fn is None:
            rec[f"{key}_ms"] = None
            continue
        # the peak-memory call warms the timed ones up
        rec[f"{key}_peak_mb"] = peak_mb(torch, lambda: fwd_bwd(fn))
        rec[f"{key}_ms"], _ = time_ms(torch, lambda: fwd_bwd(fn), reps=reps,
                                      rounds=3, graph=False, warmup=1)
    if name == "mha":
        rec["library_backends"] = sdpa_backends(
            torch, F, *(t.transpose(1, 2) for t in inputs), scale)
    return rec


def family_training_phase(torch) -> dict:
    """Main paths of training the other Synthetic probes (phase 11f of the
    module docstring): (a) kernels D and E under autograd at the 224²
    train step's shapes; (b) the full-width LoftUp and JBU steps against
    the JAX steps of ``isegprobe_torch/fixtures/
    synthetic_train_step_families.npz``; (c) a short command-line run of
    each with clicks and validation; (d) one LoftUp step at 448² with its
    slabs checkpointed; (e) two command-line steps of each other script.
    Returns the records, the path launches and the autograd records."""
    F = torch.nn.functional
    res: dict = {}
    n_key = FAMILY_GRID ** 2
    # (a) D at the LoftUp step's cross-attention (50,176 queries against
    # 256 keys), E at the four JBU stages (32² to 256²)
    grads = [autograd_case(torch, F, "mha", [
        [TRAIN_BATCH, TRAIN_CROP ** 2, 4, 101], [TRAIN_BATCH, n_key, 4, 101]],
        seed=80)]
    grads += [autograd_case(torch, F, "jbu_filter", [
        TRAIN_BATCH, FAMILY_GRID << k, FAMILY_GRID << k, 384], seed=80 + k)
        for k in range(1, 5)]
    # B with its backward kernel at LoftUp's padded rows at 448², B=4
    # (statistics over 404 of 512 and 203 of 256 channels) and at
    # SimpleViT's click encoder (588 wide, weight and bias trained)
    grads += [autograd_case(torch, F, "layernorm", shape, seed=85 + i,
                            reps=3, real=real, eps=eps, b_affine=affine)
              for i, (shape, real, eps, affine) in enumerate((
                  ((4, 28672, 512), 404, 1e-5, False),
                  ((4, 68, 448, 256), 203, 1e-5, False),
                  ((16, 1024, 588), None, 1e-6, True)))]
    for g in grads:
        print("family_autograd", json.dumps(g))
    if not all(g["ok"] for g in grads):
        fail(f"kernel B, D or E under autograd disagrees: {grads}")
    res["autograd"] = grads
    bwd_paths = {}

    # (b) the full-width steps against JAX's, from init_tree(config, 0)
    fx = dict(np.load(FAMILY_FIXTURE))
    with np.load(TRAIN_FIXTURE) as step_fx:
        items = {k: step_fx[k][:len(fx["seeds"])]
                 for k in ("images", "points", "instances")}
    paths = {}
    for name in (str(f) for f in fx["families"]):
        trainer, batch, step = step_vs_jax(
            torch, name, items, fx[f"{name}/losses"],
            fx[f"{name}/digest_names"], fx[f"{name}/digests"],
            FAMILY_TRAIN_LAUNCHES[name])
        trainer._step(batch, 2)  # warm-up of the clicker's constants
        step["profile"] = profile_forward(
            torch, lambda *_: trainer._step(batch, 2), None, None)
        trainer.shutdown()
        del trainer, batch
        print("family_step_vs_jax", json.dumps(step))
        print(f"{name} full-width train step: losses {step['losses']} (JAX "
              f"on the CPU {step['jax_cpu_losses']}), max rel err "
              f"{step['loss_rel_err']:.2e}; {step['step_ms'][1]:.1f} ms, "
              f"peak {step['peak_memory_mb']:.0f} MiB; a step with 2 clicks "
              f"busy {step['profile'].get('busy_share', 0):.0%}")
        res[f"{name}_step_vs_jax"] = step
        paths[f"{name}_train_step_vs_jax"] = step["launches"]
        bwd_paths[f"{name}_train_step_vs_jax"] = step["b_backward_launches"]
        # (c) a short run through the command line, clicks and validation
        _, cli = cli_epoch(torch, name, FAMILY_TRAIN_LAUNCHES[name],
                           FAMILY_READBACK[name],
                           [f"epoch_len={OTHER_CLI_ITEMS}",
                            f"val_epoch_len={OTHER_CLI_VAL_ITEMS}"])
        # the device-busy share of the profiled step (b), with 2 clicks
        cli["busy_share"] = step["profile"].get("busy_share")
        print("family_cli", json.dumps(cli))
        print(f"{name} through the command line: {cli['steps']} steps, "
              f"median {cli['ms_per_step_median']:.1f} ms a step (between "
              f"its events {cli['device_ms_per_step_median']:.1f} ms), data "
              f"wait {cli['data_wait_ms_median']:.1f} ms, device busy "
              f"{cli['busy_share'] or 0:.0%} of a step, peak "
              f"{cli['peak_memory_mb']:.0f} MiB; read back within "
              f"{cli['readback_rel_err']:.1e}")
        res[f"{name}_cli"] = cli
        paths[f"{name}_train_cli"] = cli["launches"]["train"]
        paths[f"{name}_train_validation"] = cli["launches"]["val"]
        bwd_paths[f"{name}_train_cli"] = cli["b_backward_launches"]

    # (d) LoftUp at 448²: its queries in 7 slabs of 64 rows, each
    # recomputed in the backward
    trainer = build([
        "model=synthetic_dinov2_loftup", "dataloader.workers=0",
        f"exp_path={scratch()}",
        f"training_params.crop_size=[{BANDED_SIZE},{BANDED_SIZE}]"])
    rng = np.random.default_rng(81)
    inst = np.zeros((BANDED_BATCH, BANDED_SIZE, BANDED_SIZE, 1), np.int8)
    points = np.full((BANDED_BATCH, 48, 3), -1.0, np.float32)
    for i in range(BANDED_BATCH):
        y0, x0 = rng.integers(40, 240, 2)
        inst[i, y0:y0 + 160, x0:x0 + 120] = 1
        points[i, 0] = (y0 + 80, x0 + 60, 0)
    batch = trainer._upload({"images": rng.integers(
        0, 256, (BANDED_BATCH, BANDED_SIZE, BANDED_SIZE, 3), np.uint8),
        "points": points, "instances": inst})
    trainer._step(batch, 0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    loss = float(trainer._step(batch, 0)[0])
    ev[1].record()
    torch.cuda.synchronize()
    banded_launches = counters()
    bwd_paths["loftup_448_train_step"] = b_backward_launches()
    want = expected(**{k: v + BANDED_RECOMPUTE.get(k, 0) for k, v in
                       FORWARD_LAUNCHES["loftup"].items()})
    if banded_launches != want or not np.isfinite(loss):
        fail(f"the 448² LoftUp step launched {banded_launches}, expected "
             f"{want} (loss {loss})")
    banded = {"size": BANDED_SIZE, "batch": BANDED_BATCH, "loss": loss,
              "step_ms": ev[0].elapsed_time(ev[1]),
              "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
              "launches": banded_launches,
              "b_backward_launches": bwd_paths["loftup_448_train_step"]}
    trainer.shutdown()
    del trainer, batch
    print("loftup_448_step", json.dumps(banded))
    print(f"LoftUp at 448², batch {BANDED_BATCH}, slabs checkpointed: "
          f"{banded['step_ms']:.1f} ms a step, peak "
          f"{banded['peak_memory_mb']:.0f} MiB")
    res["loftup_448_step"] = banded
    paths["loftup_448_train_step"] = banded_launches

    # (e) two command-line steps of every other script
    for name in OTHER_FORWARD_LAUNCHES:
        _, cli = cli_epoch(torch, name, FAMILY_TRAIN_LAUNCHES[name],
                           FAMILY_READBACK[name],
                           [f"epoch_len={OTHER_CLI_ITEMS}",
                            f"val_epoch_len={OTHER_CLI_VAL_ITEMS}"])
        print("other_cli", json.dumps(cli))
        res[f"{name}_cli"] = cli
        paths[f"{name}_train_cli"] = cli["launches"]["train"]
        paths[f"{name}_train_validation"] = cli["launches"]["val"]
        bwd_paths[f"{name}_train_cli"] = cli["b_backward_launches"]
    res["path_launches"] = paths
    res["backward_launches"] = bwd_paths
    return res


def step_at(torch, trainer, batch, num_iters: int, want: dict,
            what: str) -> dict:
    """One timed train step of ``trainer`` on ``batch`` after a warm-up:
    device ms between CUDA events, the peak allocated memory (and its part
    beyond what was allocated before the step: activations, gradients,
    the optimizer's update), and exactly the launches ``want``."""
    trainer._step(batch, num_iters)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counters()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    loss = float(trainer._step(batch, num_iters)[0])
    ev[1].record()
    torch.cuda.synchronize()
    got = counters()
    if got != want or not np.isfinite(loss):
        fail(f"{what}: a step launched {got}, expected {want} (loss {loss})")
    peak = torch.cuda.max_memory_allocated()
    return {"loss": loss, "step_ms": ev[0].elapsed_time(ev[1]),
            "peak_memory_mb": peak / 2**20,
            "step_peak_mb": (peak - base) / 2**20, "launches": got}


def drawn_batch(size: int, batch: int, seed: int) -> dict:
    """A seeded uint8 batch at ``size``² with one rectangle and a positive
    click on it per item."""
    rng = np.random.default_rng(seed)
    inst = np.zeros((batch, size, size, 1), np.int8)
    points = np.full((batch, 48, 3), -1.0, np.float32)
    for i in range(batch):
        y0, x0 = rng.integers(size // 11, size // 2, 2)
        inst[i, y0:y0 + size // 3, x0:x0 + size // 4] = 1
        points[i, 0] = (y0 + size // 6, x0 + size // 8, 0)
    return {"images": rng.integers(0, 256, (batch, size, size, 3), np.uint8),
            "points": points, "instances": inst}


def bf16_training_phase(torch) -> dict:
    """Main paths of mixed-precision training (phase 11g of the module
    docstring): (a) kernels A, B, D and E under autograd in bf16 at the
    224² train steps' shapes; (b) the full-width bf16 flagship and LoftUp
    steps against the JAX bf16 steps of ``isegprobe_torch/fixtures/
    synthetic_train_step_bf16.npz``; (c) short bf16 command-line runs of
    the flagship, LoftUp and JBU; (d) the flagship and LoftUp at 448²,
    batch 8, with and without ``remat_backbone``; (e) a resumed command-line
    run; (f) a step with one ``click_models`` tree. Returns the records,
    the path launches and the autograd records."""
    import tempfile

    from isegprobe_torch import train as train_cli
    from isegprobe_torch.models.init_tree import init_tree
    from isegprobe_torch.utils.serialization import load_checkpoint

    F = torch.nn.functional
    res: dict = {}
    paths: dict = {}
    b, n_tok, n_key = TRAIN_BATCH, FAMILY_GRID ** 2 + 1, FAMILY_GRID ** 2
    bf16 = "training_params.dtype=bfloat16"

    # (a) the four kernels under autograd in bf16, at the train steps'
    # shapes (B with float32 weight and bias, E's scalars float32)
    grads = [autograd_case(torch, F, "mha_qkv", (b, n_tok, 1152), 90,
                           reps=10, dtype="bfloat16"),
             autograd_case(torch, F, "layernorm", (b, n_tok, 384), 91,
                           reps=10, dtype="bfloat16"),
             autograd_case(torch, F, "mha", [
                 [b, TRAIN_CROP ** 2, 4, 101], [b, n_key, 4, 101]], seed=92,
                 dtype="bfloat16")]
    grads += [autograd_case(torch, F, "jbu_filter", [
        b, FAMILY_GRID << k, FAMILY_GRID << k, 384], seed=92 + k,
        dtype="bfloat16") for k in range(1, 5)]
    for g in grads:
        print("bf16_autograd", json.dumps(g))
    if not all(g["ok"] for g in grads):
        fail(f"a kernel under autograd in bf16 disagrees: {grads}")
    res["autograd"] = grads

    # (b) the full-width bf16 steps against JAX's, from init_tree(config, 0)
    fx = dict(np.load(BF16_FIXTURE))
    with np.load(TRAIN_FIXTURE) as step_fx:
        items = {k: step_fx[k] for k in ("images", "points", "instances")}
    launches = {"dinov2_noup": FORWARD_LAUNCHES["flagship"],
                "dinov2_loftup": FAMILY_TRAIN_LAUNCHES["dinov2_loftup"],
                "dinov2_jbu": FAMILY_TRAIN_LAUNCHES["dinov2_jbu"]}
    bwd_paths = {}
    for name in (str(f) for f in fx["families"]):
        batch_np = {k: v[:int(fx[f"{name}/batch"])] for k, v in items.items()}
        trainer, batch, step = step_vs_jax(
            torch, name, batch_np, fx[f"{name}/losses"],
            fx[f"{name}/digest_names"], fx[f"{name}/digests"],
            launches[name], argv=[bf16], loss_rtol=BF16_LOSS_RTOL,
            flips=BF16_FLIPS, b_backward=FLAGSHIP_B_BACKWARD
            if name == "dinov2_noup" else None)
        trainer._step(batch, 2)  # warm-up of the clicker's constants
        step["profile"] = profile_forward(
            torch, lambda *_: trainer._step(batch, 2), None, None)
        step["profile_num_iters_0"] = profile_forward(
            torch, lambda *_: trainer._step(batch, 0), None, None)
        trainer.shutdown()
        del trainer, batch
        print("bf16_step_vs_jax", json.dumps(step))
        print(f"{name} bf16 train step: losses {step['losses']} (JAX bf16 "
              f"on the CPU {step['jax_cpu_losses']}), max rel err "
              f"{step['loss_rel_err']:.2e}; {step['step_ms'][1]:.1f} ms, "
              f"peak {step['peak_memory_mb']:.0f} MiB; busy "
              f"{step['profile'].get('busy_share', 0):.0%} with 2 clicks")
        res[f"{name}_step_vs_jax"] = step
        paths[f"{name}_bf16_train_step_vs_jax"] = step["launches"]
        bwd_paths[f"{name}_bf16_train_step_vs_jax"] = \
            step["b_backward_launches"]
    # JBU, which the JAX package cannot train in bf16: the step alone
    trainer = build(["model=synthetic_dinov2_jbu", "dataloader.workers=0",
                     f"exp_path={scratch()}", bf16])
    batch = trainer._upload({k: v[:TRAIN_BATCH] for k, v in items.items()})
    step = step_at(torch, trainer, batch, 0, expected(
        **launches["dinov2_jbu"]), "dinov2_jbu bf16 step")
    step["profile"] = profile_forward(
        torch, lambda *_: trainer._step(batch, 2), None, None)
    step["profile_num_iters_0"] = profile_forward(
        torch, lambda *_: trainer._step(batch, 0), None, None)
    trainer.shutdown()
    del trainer, batch
    print("bf16_jbu_step", json.dumps(step))
    print(f"dinov2_jbu bf16 train step: {step['step_ms']:.1f} ms, peak "
          f"{step['peak_memory_mb']:.0f} MiB; busy "
          f"{step['profile'].get('busy_share', 0):.0%} with 2 clicks")
    res["dinov2_jbu_step"] = step
    paths["dinov2_jbu_bf16_train_step"] = step["launches"]

    # (c) short bf16 runs through the command line, clicks and validation
    # (the flagship's is (e)'s first run; 11f (c) reads LoftUp's and JBU's
    # checkpoints back, the same writer from float32 master weights)
    for name in ("dinov2_loftup", "dinov2_jbu"):
        _, cli = cli_epoch(torch, name, launches[name], None,
                           [bf16, f"epoch_len={OTHER_CLI_ITEMS}",
                            f"val_epoch_len={OTHER_CLI_VAL_ITEMS}"])
        print("bf16_cli", json.dumps(cli))
        print(f"{name} bf16 through the command line: {cli['steps']} steps, "
              f"median {cli['ms_per_step_median']:.1f} ms a step (between "
              f"its events {cli['device_ms_per_step_median']:.1f} ms), peak "
              f"{cli['peak_memory_mb']:.0f} MiB")
        res[f"{name}_cli"] = cli
        paths[f"{name}_bf16_train_cli"] = cli["launches"]["train"]
        paths[f"{name}_bf16_train_validation"] = cli["launches"]["val"]
        bwd_paths[f"{name}_bf16_train_cli"] = cli["b_backward_launches"]

    # (d) 448², batch 8, with and without remat: the flagship and LoftUp
    recompute = {"mha_qkv": 12, "layernorm": 24}  # each block once more
    big = drawn_batch(BANDED_SIZE, BANDED_BATCH, 95)
    for name in ("dinov2_noup", "dinov2_loftup"):
        per_forward = (FORWARD_LAUNCHES["flagship"] if name == "dinov2_noup"
                       else FORWARD_LAUNCHES["loftup"])
        for remat in (False, True):
            trainer = build([
                f"model=synthetic_{name}", "dataloader.workers=0",
                f"exp_path={scratch()}", bf16,
                f"training_params.crop_size=[{BANDED_SIZE},{BANDED_SIZE}]",
                f"training_params.remat_backbone={str(remat).lower()}"])
            extra = dict(recompute) if remat else {}
            if name == "dinov2_loftup":
                for k, v in BANDED_RECOMPUTE.items():
                    extra[k] = extra.get(k, 0) + v
            want = expected(**{k: v + extra.get(k, 0)
                               for k, v in per_forward.items()})
            what = f"{name} bf16 448² remat={remat}"
            batch = trainer._upload(big)
            rec = step_at(torch, trainer, batch, 0, want, what)
            rec["profile"] = profile_forward(
                torch, lambda *_: trainer._step(batch, 0), None, None)
            rec.update(model=name, size=BANDED_SIZE, batch=BANDED_BATCH,
                       remat=remat)
            trainer.shutdown()
            del trainer, batch
            print("bf16_448_step", json.dumps(rec))
            print(f"{what}: {rec['step_ms']:.1f} ms a step, peak "
                  f"{rec['peak_memory_mb']:.0f} MiB ({rec['step_peak_mb']:.0f}"
                  f" MiB beyond what was allocated before it), busy "
                  f"{rec['profile'].get('busy_share', 0):.0%}")
            res[f"{name}_448_remat_{remat}"] = rec
            paths[f"{name}_bf16_448_remat_{remat}"] = rec["launches"]

    # (e) resuming: the flagship's bf16 command-line run, then the same
    # run resumed
    per_step: dict = {}
    checker = step_checker("resume", FORWARD_LAUNCHES["flagship"], per_step)
    argv = [bf16, f"epoch_len={FAMILY_CLI_ITEMS}",
            f"val_epoch_len={FAMILY_CLI_VAL_ITEMS}"]
    with tempfile.TemporaryDirectory() as tmp:
        first, cli = cli_epoch(torch, "dinov2_noup", launches["dinov2_noup"],
                               TRAIN_READBACK, argv, exp_path=tmp)
        print("bf16_cli", json.dumps(cli))
        print(f"dinov2_noup bf16 through the command line: {cli['steps']} "
              f"steps, median {cli['ms_per_step_median']:.1f} ms a step "
              f"(between its events {cli['device_ms_per_step_median']:.1f} "
              f"ms), peak {cli['peak_memory_mb']:.0f} MiB; read back within "
              f"{cli['readback_rel_err']:.1e}")
        res["dinov2_noup_cli"] = cli
        paths["dinov2_noup_bf16_train_cli"] = cli["launches"]["train"]
        paths["dinov2_noup_bf16_train_validation"] = cli["launches"]["val"]
        ckpt = Path(first.cfg.CHECKPOINTS_PATH) / "last_checkpoint.ckpt"
        saved, _, _ = load_checkpoint(ckpt)
        again = build(["model=synthetic_dinov2_noup",
                       f"dataloader.workers={TRAIN_WORKERS}", *argv,
                       f"exp_path={tmp}", "training.resume_exp=0",
                       "training.start_epoch=1"], on_step=checker)
        loaded = again.full_params(tuple(saved))
        if again.cfg.CHECKPOINTS_PATH != first.cfg.CHECKPOINTS_PATH or any(
                not np.array_equal(x, y)
                for x, y in zip(_leaves(loaded), _leaves(saved))):
            fail("the resumed run did not load the saved leaves bitwise "
                 "into its own run directory")
        zero_counters()
        again.run(2, start_epoch=1, validation=False)
        again.shutdown()
        moved, _, extra = load_checkpoint(ckpt)
        changed = sum(not np.array_equal(x, y)
                      for x, y in zip(_leaves(moved), _leaves(saved)))
        if extra != {"epoch": 1} or not changed:
            fail(f"the resumed run did not move the saved leaves "
                 f"({changed} changed, extra {extra})")
    resume = {"leaves": len(_leaves(saved)), "loaded_bitwise": True,
              "moved_leaves": changed,
              "launches": {c: sum(x[c] for x in per_step["train"])
                           for c in KERNELS}}
    print("bf16_resume", json.dumps(resume))
    res["resume"] = resume
    paths["resume_train"] = resume["launches"]

    # (f) click_models: the first simulated click through another head
    # (the head of init_tree's seed 1), the frozen tensors shared
    argv = ["model=synthetic_dinov2_noup", "dataloader.workers=0",
            f"exp_path={scratch()}", bf16]
    other = {"head": init_tree(train_cli.model_kwargs(train_cli.parse_args(
        argv)), 1, skip=("backbone", "upsampler", "embed_coords"))["head"]}
    ens = build(argv, click_models=[other])
    (state,) = ens._click_states
    model_bytes = sum(p.numel() * p.element_size()
                      for p in ens.model.parameters())
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    batch = ens._upload({k: v[:TRAIN_BATCH] for k, v in items.items()})
    rec = step_at(torch, ens, batch, 2, expected(
        **{k: 3 * v for k, v in FORWARD_LAUNCHES["flagship"].items()},
        edt_row_envelope=2), "click_models step")
    rec.update(click_model_tensors=len(state), click_model_bytes=state_bytes,
               model_bytes=model_bytes)
    if sorted({k.split(".")[0] for k in state}) != ["head"]:
        fail(f"the click model holds other tensors than the head's: "
             f"{sorted(state)}")
    ens.shutdown()
    del ens, batch
    print("bf16_click_models", json.dumps(rec))
    res["click_models"] = rec
    paths["click_models_step"] = rec["launches"]
    res["path_launches"] = paths
    res["backward_launches"] = bwd_paths
    return res


def pixel_digest(array: np.ndarray) -> str:
    """sha256 of an array's dtype, shape and bytes (the data fixture's)."""
    import hashlib

    a = np.ascontiguousarray(array)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                          + a.tobytes()).hexdigest()


def item_digest(item: dict) -> str:
    """sha256 of a training item's images, points and instances."""
    import hashlib

    h = hashlib.sha256()
    for key in ("images", "points", "instances"):
        a = np.ascontiguousarray(item[key])
        h.update(f"{key}{a.dtype}{a.shape}".encode() + a.tobytes())
    return h.hexdigest()


def loader_epochs(dataset, seed: int, salt: str, processes: bool,
                  epochs: int) -> tuple:
    """``epochs`` passes of a ``DataLoader`` over ``dataset`` (batches of
    8, not shuffled) with ``DATA_WORKERS`` threads or spawned processes,
    one pool for all: the first pass's items (positions 0-7, index =
    position, epoch 0), the seconds of the first pass (a process pool's
    start-up included) and ms an item over the passes after the second
    (the second warms up the workers the first pass left idle; None for
    fewer than three passes)."""
    from isegprobe_torch.data.loader import DataLoader

    loader = DataLoader(dataset, 8, shuffle=False, num_workers=DATA_WORKERS,
                        seed=seed, salt=salt, use_processes=processes)
    later_ms = None
    try:
        t0 = time.time()
        batch = next(iter(loader))
        first_s = time.time() - t0
        if epochs >= 3:
            for _ in loader:
                pass
            t0 = time.time()
            n = sum(len(b["images"]) for _ in range(epochs - 2)
                    for b in loader)
            later_ms = 1e3 * (time.time() - t0) / n
    finally:
        loader.shutdown()
    items = [{k: v[i] for k, v in batch.items()} for i in range(8)]
    return items, first_s, later_ms


def data_phase(torch) -> dict:
    """Main paths of the paper's data (phase 11h of the module docstring):
    (a) decoding every file of the trees; (b) the SBD items from loader
    threads and processes; (c) the SBD steps against JAX's and two
    command-line steps of each SBD script; (d) the evaluate CLI on the five
    evaluation trees, device loop and host protocol, against JAX's
    trajectories. Returns the records and the path launches."""
    from isegprobe_torch import evaluate as evaluate_cli
    from isegprobe_torch.data import image_io
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.train import sbd_datasets

    res: dict = {}
    fx = dict(np.load(DATA_FIXTURE))

    # (a) decoding: every file to cv2.imread's pixels
    t0 = time.time()
    for name, want in zip(fx["file_names"], fx["file_digests"]):
        if pixel_digest(image_io.read_bgr(DATA_TREES / name)) != want:
            fail(f"{name} decodes to other pixels than cv2.imread's")
    decode_all_s = time.time() - t0
    sbd_jpegs = sorted((DATA_TREES / "sbd" / "img").glob("*.jpg"))
    per_file = []
    for path in sbd_jpegs:
        t0 = time.time()
        for _ in range(5):
            image_io.read_rgb(path)
        per_file.append((time.time() - t0) / 5)
    res["decode"] = {"files": len(fx["file_names"]),
                     "all_s": decode_all_s,
                     "ms_per_sbd_jpeg_median": 1e3 * float(np.median(
                         per_file)),
                     "sbd_jpeg_shape": list(image_io.read_rgb(
                         sbd_jpegs[0]).shape)}
    print("data_decode", json.dumps(res["decode"]))

    # (b) the SBD items, threads and processes, against JAX's digests; ms
    # an item over four more passes of the same pool
    trainset, valset = sbd_datasets(DATA_TREES / "sbd")
    items, rec = {}, {}
    for split, ds in (("train", trainset), ("val", valset)):
        for row, seed in enumerate(DATA_SEEDS):
            modes = (False, True) if (split, seed) == ("train", 0) \
                else (False,)
            for processes in modes:
                mode = "processes" if processes else "threads"
                timed = (split, seed) == ("train", 0)
                got, first_s, later_ms = loader_epochs(
                    ds, seed, split, processes, 5 if timed else 1)
                for pos, item in enumerate(got):
                    if item_digest(item) != fx[f"items_{split}"][row][pos]:
                        fail(f"SBD {split} item {pos} of seed {seed} "
                             f"({mode}) differs from the JAX item")
                rec[f"{split}_seed{seed}_{mode}_first_batch_s"] = first_s
                if timed:
                    rec[f"ms_per_item_{mode}"] = later_ms
                items[(split, seed)] = got
    res["items"] = rec
    print("data_items", json.dumps(rec))

    # (c) the SBD steps against JAX's, and two command-line steps of each
    from isegprobe_torch.data.loader import _stack

    batch_np = _stack(items[("train", 0)])
    steps, cli, launches = {}, {}, {}
    for key in ("sbd_dinov2_noup", "sbd_dinov2_bilinear"):
        trainer, _, step = step_vs_jax(
            torch, key, batch_np, fx[f"step_{key}_losses"],
            fx["step_digest_names"], fx[f"step_{key}_digests"],
            FORWARD_LAUNCHES["flagship"],
            [f"DATASETS.SBD_PATH={DATA_TREES / 'sbd'}"])
        trainer.shutdown()
        del trainer
        print("data_step_vs_jax", json.dumps(step))
        steps[key] = step
        launches[f"{key}_step_vs_jax"] = step["launches"]
        mp = key == "sbd_dinov2_bilinear"
        _, run = cli_epoch(
            torch, key, FORWARD_LAUNCHES["flagship"], TRAIN_READBACK,
            [f"DATASETS.SBD_PATH={DATA_TREES / 'sbd'}",
             f"epoch_len={DATA_CLI_ITEMS}",
             f"val_epoch_len={DATA_CLI_VAL_ITEMS}",
             f"dataloader.mp={str(mp).lower()}"])
        run["loader"] = "processes" if mp else "threads"
        print("data_cli", json.dumps(run))
        cli[key] = run
        launches[f"{key}_cli_train"] = run["launches"]["train"]
        launches[f"{key}_cli_val"] = run["launches"]["val"]
    res["steps"], res["cli"] = steps, cli

    # (d) the evaluate CLI on the five trees, against JAX's trajectories
    args = [f"checkpoint={TRAINED_CKPTS['flagship']}", "eval_mode=fixed448",
            f"n_clicks={TRAINED_CLICKS}", "print_ious=false",
            f"datasets={','.join(DATA_EVAL)}",
            *(f"DATASETS.{k}_PATH={DATA_TREES / v}"
              for k, v in DATA_PATH_KEYS.items())]
    cfg = evaluate_cli.parse_args(args + [
        "device_loop=true", f"device_batch={TRAINED_BATCH}",
        "device_refill=true"])
    model, _ = eval_load(torch, cfg["checkpoint"], torch.float32,
                         cfg["target_size"])
    evals, total_steps = {}, 0
    loop_launches = expected()
    for name in DATA_EVAL:
        want_ious = fx[f"eval_{name}_ious"]
        want_n, want_clicks = fx[f"eval_{name}_n"], fx[f"eval_{name}_clicks"]
        n_obj = len(want_n)
        clicks: list = []
        torch.cuda.synchronize()
        zero_counters()
        out = evaluate_cli.evaluate(cfg, model, name, clicks=clicks)
        torch.cuda.synchronize()
        got_launches = counters()
        steps_run = out["group_stats"]["steps"]
        if got_launches != expected(**{k: v * steps_run
                                       for k, v in PER_STEP.items()}):
            fail(f"{name} device loop launched {got_launches} in "
                 f"{steps_run} steps")
        loop_launches = {k: loop_launches[k] + got_launches[k]
                         for k in KERNELS}
        total_steps += steps_run
        loop = against_fixture(out["all_ious"], clicks, want_ious, want_n,
                               want_clicks, f"{name} f32 device loop",
                               TRAINED_MAX_DIVERGED)
        want_noc = compute_noc_metric(
            [want_ious[i, :want_n[i]] for i in range(n_obj)],
            [0.8, 0.85, 0.9], TRAINED_CLICKS)[0]
        noc_err = float(np.abs(np.asarray(out["noc"])
                               - np.asarray(want_noc)).max())
        if noc_err > TRAINED_NOC_TOL:
            fail(f"{name}: device-loop NoC {out['noc']} against JAX's "
                 f"{want_noc}")
        # the host protocol on the dataset's first object
        host_cfg = dict(cfg, device_loop=False, device_refill=False)
        dataset = evaluate_cli.get_dataset(name, cfg)
        host_clicks: list = []
        zero_counters()
        t0 = time.time()
        host = evaluate_cli.evaluate(host_cfg, model, name,
                                     clicks=host_clicks,
                                     dataset=_One(dataset))
        host_s = time.time() - t0
        n_host = sum(len(a) for a in host["all_ious"])
        if counters() != expected(**{k: v * n_host for k, v in
                                     FORWARD_LAUNCHES["flagship"].items()}):
            fail(f"{name} host protocol launched {counters()} for "
                 f"{n_host} clicks")
        host_rec = against_fixture(host["all_ious"], host_clicks,
                                   want_ious[:1], want_n[:1],
                                   want_clicks[:1],
                                   f"{name} f32 host protocol", 0)
        evals[name] = {
            "objects": n_obj, "noc": list(out["noc"]),
            "jax_noc": list(want_noc), "noc_err": noc_err,
            "loop_steps": steps_run,
            "loop_ms_per_step": 1e3 * out["elapsed"] / steps_run,
            "loop": loop, "group_stats": out["group_stats"],
            "host_clicks": n_host,
            "host_ms_per_click": 1e3 * host_s / n_host, "host": host_rec}
        print("data_eval", name, json.dumps(evals[name]))
    res["evaluate"] = evals
    launches["eval_device_loop"] = loop_launches
    res["path_launches"] = launches
    print(f"paper's data: {len(fx['file_names'])} files decoded as cv2 "
          f"does ({res['decode']['ms_per_sbd_jpeg_median']:.2f} ms an SBD "
          f"JPEG), SBD items equal to JAX's ({rec['ms_per_item_threads']:.1f}"
          f" ms an item with threads, {rec['ms_per_item_processes']:.1f} "
          f"with processes); SBD steps within "
          f"{max(v['loss_rel_err'] for v in steps.values()):.2e} of JAX's "
          f"losses; NoC@90 " + ", ".join(
              f"{k} {v['noc'][2]:.2f}" for k, v in evals.items()))
    return res


class _One:
    """A dataset's first sample alone (the host protocol's subset)."""

    def __init__(self, dataset) -> None:
        self.dataset = dataset

    def __len__(self) -> int:
        return 1

    def get_sample(self, index: int):
        return self.dataset.get_sample(0)


# the rest of the host protocol (phase 11i): the JAX package's BRS results
# for the trained flagship at 448² (tests/test_torch_brs.py --export), the
# objective's seeded point (x ~ N(0, scale) from BRS_X_SEED, the scale by
# mode) and the gates: the strict gate (b), the objective's value within
# 1e-5 relative and its gradient within 1e-4 of its largest magnitude of
# JAX's (f32 on both sides, summed in other orders); (c) IoUs within
# LOOP_IOU_TOL up to an object's first click where the L-BFGS evaluation
# counts, the early stops or the clicks part from JAX's, at most
# TRAINED_MAX_DIVERGED of the 8 objects parting; (e) an upsampler's
# objective with its kernel against the same objective with the plain
# version swapped in, 1e-4 of the value and of the gradient's largest
# magnitude (the kernel's forward rounding through the upsampler and the
# head: LoftUp's 7 slabs, JBU's 4 stages). The trees' clicker inputs are
# each object's error masks against its ground truth shifted by
# BRS_EDT_SHIFT pixels; EDT and click times are host wall times, medians
# over BRS_EDT_REPS calls
BRS_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
               / "fixtures" / "synthetic_brs.npz")
BRS_X_SEED = 17
BRS_X_SCALE = {"f-BRS": 0.1, "input": 0.003}
BRS_VALUE_TOL = 1e-5
BRS_GRAD_TOL = 1e-4
BRS_RUNS = {"f-BRS-B": (8, 20), "DistMap-BRS": (2, 5), "RGB-BRS": (1, 3)}
BRS_OBJECTIVE_MODES = ("f-BRS-B", "RGB-BRS", "DistMap-BRS")
BRS_UPSAMPLER_TOL = 1e-4
BRS_UPSAMPLER_MAXFUN = 3
BRS_EDT_SHIFT = 7
BRS_EDT_REPS = 7
BRS_CROP_TILE = (320, 480)
BRS_ENSEMBLE = ("synthetic_dinov2_noup_80ep.ckpt",
                "synthetic_dinov2_noup_160ep.ckpt")


def brs_seeded_x(mode: str, size: int) -> np.ndarray:
    scale = BRS_X_SCALE["f-BRS" if mode.startswith("f-BRS") else "input"]
    return np.random.default_rng(BRS_X_SEED).normal(0.0, scale, size)


class _Capture:
    """Within the block, ``brs.fmin_l_bfgs_b`` records the objective it is
    handed and returns ``x0``, or, with ``run``, runs scipy's as well."""

    def __init__(self, brs, run: bool = False) -> None:
        self.brs, self.run, self.func = brs, run, None

    def __enter__(self):
        self.real = self.brs.fmin_l_bfgs_b

        def capture(func, x0, **kw):
            self.func = func
            if self.run:
                return self.real(func=func, x0=x0, **kw)
            return x0, 0.0, {}

        self.brs.fmin_l_bfgs_b = capture
        return self

    def __exit__(self, *exc):
        self.brs.fmin_l_bfgs_b = self.real


class _ClickRecords:
    """Within the block, every BRS click appends its L-BFGS evaluations,
    early stop, ``opt_data`` norm, host ms and kernel launches to
    ``records``."""

    def __init__(self, torch, brs) -> None:
        self.torch, self.brs, self.records = torch, brs, []

    def __enter__(self):
        cls = self.brs._BRSPredictorBase
        self.real = real = cls.get_prediction
        torch, records = self.torch, self.records

        def get_prediction(predictor, clicker, prev_mask=None):
            torch.cuda.synchronize()
            before = counters()
            t0 = time.perf_counter()
            out = real(predictor, clicker, prev_mask)
            ms = 1e3 * (time.perf_counter() - t0)
            after = counters()
            functor = predictor.opt_functor
            records.append({
                "evals": functor.n_evals, "stop": functor.stop,
                "opt_norm": float(np.linalg.norm(predictor.opt_data)),
                "ms": ms, "launches": {k: after[k] - before[k]
                                       for k in KERNELS}})
            return out

        cls.get_prediction = get_prediction
        return self

    def __exit__(self, *exc):
        self.brs._BRSPredictorBase.get_prediction = self.real


def brs_objective_error(value, grad, fx, mode: str, k: int) -> dict:
    """The port's value and gradient at the fixture's ``k``-th point (0:
    x = 0, 1: the seeded x) against JAX's: the value's relative error, the
    gradient's error on the stored entries over its largest magnitude, and
    the relative errors of that magnitude and of the L2 norm."""
    want_v = float(fx[f"b_{mode}_value"][k])
    maxabs = float(fx[f"b_{mode}_grad_maxabs"][k])
    l2 = float(fx[f"b_{mode}_grad_l2"][k])
    idx = fx[f"b_{mode}_grad_idx"]
    return {"value": value, "jax_value": want_v,
            "value_rel_err": abs(value - want_v) / abs(want_v),
            "grad_err": float(np.abs(grad[idx] - fx[f"b_{mode}_grad_sample"][k])
                              .max()) / maxabs,
            "grad_maxabs_rel_err": abs(float(np.abs(grad).max()) - maxabs)
            / maxabs,
            "grad_l2_rel_err": abs(float(np.linalg.norm(grad)) - l2) / l2,
            "entries_compared": int(idx.size), "entries": int(grad.size)}


def brs_against_fixture(ious, clicks, records, fx, mode: str) -> dict:
    """Hold a BRS run's per-object trajectories against the JAX package's
    (the fixture's ``c_{mode}_*``): IoUs within LOOP_IOU_TOL up to each
    object's first click where the L-BFGS evaluation counts, the early
    stops (whether the click's last evaluation handed scipy a zero
    gradient) or the clicks part, or where one run stops and the other
    clicks on; at most TRAINED_MAX_DIVERGED objects may part, each printed
    with its click and cause."""
    n_obj = len(ious)
    partings, err, offset = [], 0.0, 0
    for i in range(n_obj):
        n = int(fx[f"c_{mode}_n"][i])
        want_c = [tuple(int(v) for v in c)
                  for c in fx[f"c_{mode}_clicks"][i, :n]]
        want_e = [int(v) for v in fx[f"c_{mode}_evals"][i, :n]]
        want_s = [bool(v) for v in fx[f"c_{mode}_stopped"][i, :n]]
        recs = records[offset:offset + len(ious[i])]
        offset += len(ious[i])
        got_c = [tuple(int(v) for v in c) for c in clicks[i]]
        got_e = [r["evals"] for r in recs]
        got_s = [r["stop"] is not None for r in recs]
        k, cause = None, None
        for j in range(min(len(got_c), n)):
            for what, got, want in (("click", got_c, want_c),
                                    ("evaluations", got_e, want_e),
                                    ("early stop", got_s, want_s)):
                if got[j] != want[j]:
                    k, cause = j, f"{what}: {got[j]} here, {want[j]} in JAX"
                    break
            if k is not None:
                break
        if k is None and len(got_c) != n:
            k = min(len(got_c), n)
            cause = f"{len(got_c)} clicks here, {n} in JAX"
        upto = len(got_c) if k is None else k
        if upto:
            err = max(err, float(np.abs(np.asarray(ious[i][:upto])
                                        - fx[f"c_{mode}_ious"][i, :upto])
                                 .max()))
        if k is not None:
            partings.append({"object": i, "click": k + 1, "cause": cause})
    if offset != len(records):
        fail(f"{mode}: {len(records)} BRS clicks recorded for {offset}")
    for d in partings:
        print(f"{mode}: object {d['object']} parts from JAX at click "
              f"{d['click']}: {d['cause']}")
    if err > LOOP_IOU_TOL:
        fail(f"{mode}: IoUs differ from JAX's by {err} > {LOOP_IOU_TOL} "
             "before the runs part")
    if len(partings) > TRAINED_MAX_DIVERGED:
        fail(f"{mode}: {len(partings)} objects part from JAX (at most "
             f"{TRAINED_MAX_DIVERGED} allowed)")
    return {"max_iou_diff_before_parting": err, "partings": partings}


def _tree_error_masks(gt: np.ndarray) -> list:
    """The clicker's two EDT inputs for ``gt`` against a prediction that
    is ``gt`` shifted by BRS_EDT_SHIFT pixels: each error region padded by
    one pixel, as ``inference/clicker.py`` pads it."""
    obj = gt == 1
    pred = np.roll(obj, (BRS_EDT_SHIFT, -BRS_EDT_SHIFT), axis=(0, 1))
    valid = gt != -1
    return [np.pad(m & valid, 1).astype(np.uint8)
            for m in (obj & ~pred, ~obj & pred)]


def _one_evaluation(functor, x) -> None:
    """One L-BFGS evaluation as scipy makes it, its host reads included;
    the IoU plateau's reference mask is cleared, so that a repeat at the
    same ``x`` reads the gradient back as the first call does."""
    functor._last_mask = None
    functor(x)


def _host_ms(fn, reps: int = BRS_EDT_REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def host_edt_part(torch, evaluate_cli, model, cfg) -> dict:
    """(a) the native host EDT: bitwise against its plain version on the
    clicker's inputs of the five trees, its time and the plain version's
    at 480x640 and 854x480, the host click (the NoBRS Predictor with the
    native clicker) on the first DAVIS and GrabCut objects, and an SBD
    training item from DATA_WORKERS loader threads (the click sampler's
    EDT is the same library)."""
    from isegprobe_torch.inference.evaluation import (
        evaluate_sample,
        latency_percentiles,
    )
    from isegprobe_torch.inference.brs import get_predictor
    from isegprobe_torch.ops import edt
    from isegprobe_torch.train import sbd_datasets

    res: dict = {}
    masks, shapes = 0, {}
    for name in DATA_EVAL:
        dataset = evaluate_cli.get_dataset(name, cfg)
        for index in range(len(dataset)):
            sample = dataset.get_sample(index)
            for obj in sample.objects_ids:
                for m in _tree_error_masks(sample.gt_mask(obj)):
                    if not np.array_equal(edt.edt_l2sq(m),
                                          edt.edt_l2sq_plain(m)):
                        fail(f"native EDT differs from scipy on {name} "
                             f"sample {index}")
                    masks += 1
                    shapes[tuple(m.shape)] = m
    res["bitwise_masks"] = masks
    timing = {}
    for hw in ((480, 640), (854, 480)):
        padded = (hw[0] + 2, hw[1] + 2)
        m = shapes.get(padded)
        if m is None:
            m = np.pad(scene(5, hw)[1].astype(bool), 1).astype(np.uint8)
        timing[f"{hw[0]}x{hw[1]}"] = {
            "native_ms": _host_ms(lambda: edt.edt_l2sq(m)),
            "plain_ms": _host_ms(lambda: edt.edt_l2sq_plain(m))}
    res["edt_ms"] = timing
    clicks = {}
    for name in ("DAVIS", "GrabCut"):
        dataset = evaluate_cli.get_dataset(name, cfg)
        zoom = evaluate_cli.get_zoomin_params(False, "fixed448", name)
        predictor = get_predictor(
            model, zoom_in_params=zoom,
            predictor_params={"net_clicks_limit": TRAINED_CLICKS})
        sample = dataset.get_sample(0)
        gt = sample.gt_mask(sample.objects_ids[0])
        evaluate_sample(sample.image, gt, predictor, max_iou_thr=2.0,
                        max_clicks=1)  # warm-up
        stamps = []
        t0 = time.perf_counter()
        _, ious, _ = evaluate_sample(
            sample.image, gt, predictor, max_iou_thr=2.0,
            pred_thr=TRAINED_THRESH, max_clicks=TRAINED_CLICKS,
            callback=lambda *a: stamps.append(time.perf_counter()))
        per_click = np.diff([t0] + stamps)
        clicks[name] = {"hw": list(gt.shape), "clicks": len(ious),
                        **latency_percentiles(list(per_click))}
    res["host_click"] = clicks
    trainset, _ = sbd_datasets(DATA_TREES / "sbd")
    _, _, res["sbd_ms_per_item_threads"] = loader_epochs(
        trainset, 0, "train", False, 5)
    print("brs_host_edt", json.dumps(res))
    return res


def brs_phase(torch, F) -> dict:
    """Main paths of the rest of the host protocol (phase 11i of the module
    docstring): (a) the native host EDT; (b) the BRS objective of the
    trained flagship at fixed points against JAX's; (c) f-BRS-B,
    DistMap-BRS and RGB-BRS trajectories through the evaluate CLI against
    JAX's, with (d) their exact launches a click; (e) f-BRS on drawn LoftUp
    and JBU probes, kernels D and E under autograd against their plain
    versions; (f) CropsPredictor against the transform chain and a
    two-member ensemble against JAX's; (g) A, B, D and E under autograd at
    batch 1. Returns the records, the autograd cases and the path
    launches."""
    from isegprobe_torch import evaluate as evaluate_cli
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference import brs
    from isegprobe_torch.inference.clicker import Click, Clicker
    from isegprobe_torch.inference.evaluation import evaluate_dataset
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.inference.predictor import (
        CropsPredictor,
        TransformChainPredictor,
    )
    from isegprobe_torch.inference.transforms import (
        AddHorizontalFlip,
        Crops,
        SigmoidForPred,
    )
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_torch.models.vit import init_params
    from isegprobe_torch.ops import attention, jbu

    res: dict = {}
    launches: dict = {}
    bwd_launches: dict = {}
    fx = dict(np.load(BRS_FIXTURE))
    size = (448, 448)
    per_forward = FORWARD_LAUNCHES["flagship"]
    tree_args = [*(f"DATASETS.{k}_PATH={DATA_TREES / v}"
                   for k, v in DATA_PATH_KEYS.items())]
    base = [f"checkpoint={TRAINED_CKPTS['flagship']}", "eval_mode=fixed448",
            f"thresh={TRAINED_THRESH}", "print_ious=false",
            f"target_iou={TRAINED_TARGET}", *tree_args]
    cfg = evaluate_cli.parse_args(base)
    model, _ = eval_load(torch, cfg["checkpoint"], torch.float32, size)

    # (a) the native host EDT
    res["host_edt"] = host_edt_part(torch, evaluate_cli, model, cfg)

    # (b) the objective at the fixture's two points and states
    data = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, 8))
    sample = data.get_sample(0)
    states = {"object_roi": tuple(int(v) for v in fx["b_roi"]),
              "prev_prediction": fx["b_prev"].astype(np.float32)}
    zoom = {"skip_clicks": -1, "target_size": size}
    objective = {}
    for mode in BRS_OBJECTIVE_MODES:
        p = brs.get_predictor(model, mode, prob_thresh=TRAINED_THRESH,
                              zoom_in_params=zoom,
                              predictor_params={"net_clicks_limit":
                                                TRAINED_CLICKS})
        p.set_input_image(sample.image)
        p.set_states(states)
        clicker = Clicker()
        for y, x, pos in fx["b_clicks"]:
            clicker.add_click(Click(bool(pos), (int(y), int(x))))
        with _Capture(brs) as cap:
            p.get_prediction(clicker)
        n = 2 * 384 if mode.startswith("f-BRS") else int(np.prod(size)) * 3
        rec = {"entries": n, "points": []}
        for k, x in enumerate((np.zeros(n), brs_seeded_x(mode, n))):
            zero_counters()
            value, grad, *_ = cap.func.value_and_grad(x)
            got_launches = counters()
            got_bwd = b_backward_launches()
            err = brs_objective_error(float(value),
                                      grad.double().cpu().numpy(), fx, mode,
                                      k)
            rec["points"].append(err)
            if (err["value_rel_err"] > BRS_VALUE_TOL
                    or err["grad_err"] > BRS_GRAD_TOL):
                fail(f"{mode} objective at point {k} differs from JAX's: "
                     f"{err}")
        # an evaluation's launches and ms (the host reads of __call__ in)
        rec["launches_per_evaluation"] = {
            k: v for k, v in got_launches.items() if v}
        # Input-BRS differentiates through the backbone, so B's backward
        # kernel runs in each of its evaluations (twice a LayerNorm where
        # the loaded weights require a gradient); f-BRS optimizes after
        # the backbone
        rec["b_backward_launches_per_evaluation"] = got_bwd
        if not mode.startswith("f-BRS") and not got_bwd:
            fail(f"{mode}: an evaluation launched no B backward")
        rec["ms_per_evaluation"] = _host_ms(
            lambda: _one_evaluation(cap.func, x), reps=5)
        rec["profile"] = profile_forward(
            torch, lambda *_: _one_evaluation(cap.func, x), None, None)
        objective[mode] = rec
        print("brs_objective", mode, json.dumps(rec))
    res["objective"] = objective
    with torch.inference_mode():
        crop = torch.rand((1, *size, 4), device="cuda")
        pts = torch.full((1, 2 * TRAINED_CLICKS, 3), -1.0, device="cuda")
        pts[0, 0] = torch.tensor([200.0, 200.0, 0.0])
        res["forward_b1_ms"], _ = time_ms(torch, lambda: model(crop, pts),
                                          reps=5, rounds=3, graph=False)

    # (c, d) trajectories through the CLI, launches a click
    runs = {}
    for mode, (n_obj, n_clicks) in BRS_RUNS.items():
        device_loop = mode == "RGB-BRS"  # a BRS mode asks for the loop
        run_cfg = evaluate_cli.parse_args(
            base + [f"mode={mode}", f"n_clicks={n_clicks}",
                    f"device_loop={str(device_loop).lower()}"])
        clicks: list = []
        with _ClickRecords(torch, brs) as rec:
            torch.cuda.synchronize()
            zero_counters()
            out = evaluate_cli.evaluate(
                run_cfg, model, "Synthetic", clicks=clicks,
                dataset=SceneDataset(SYNTHETIC_FIXTURE,
                                     objects=slice(0, n_obj)))
            torch.cuda.synchronize()
            total = counters()
            bwd_total = b_backward_launches()
        if out["protocol"] != "host" or (device_loop and not out["note"]):
            fail(f"mode={mode} device_loop={device_loop} ran "
                 f"{out['protocol']} ({out['note']})")
        records = rec.records
        for r in records:
            # f-BRS: the trunk once a click; Input-BRS: a forward an
            # evaluation, one forward on a click without any
            times = 1 if mode.startswith("f-BRS") else max(r["evals"], 1)
            if r["launches"] != expected(**{k: v * times for k, v in
                                            per_forward.items()}):
                fail(f"{mode} click launched {r['launches']} for "
                     f"{r['evals']} evaluations")
        summed = {k: sum(r["launches"][k] for r in records) for k in KERNELS}
        if total != summed:
            fail(f"{mode}: {total} launched in all, {summed} by the clicks")
        launches[f"brs_{mode}"] = total
        bwd_launches[f"brs_{mode}"] = bwd_total
        gate = brs_against_fixture(out["all_ious"], clicks, records, fx,
                                   mode)
        want_noc = compute_noc_metric(
            [fx[f"c_{mode}_ious"][i, :fx[f"c_{mode}_n"][i]]
             for i in range(n_obj)], [0.8, 0.85, 0.9], n_clicks)[0]
        evals = sum(r["evals"] for r in records)
        optimized = [r for r in records if r["evals"]]
        runs[mode] = {
            "objects": n_obj, "clicks": len(records), "noc": list(out["noc"]),
            "jax_noc": list(want_noc), "evaluations": evals,
            "jax_evaluations": int(fx[f"c_{mode}_evals"].sum()),
            "evaluations_per_optimized_click": evals / max(len(optimized), 1),
            "ms_per_click": float(np.mean([r["ms"] for r in records])),
            "ms_per_click_p50": float(np.median([r["ms"] for r in records])),
            "ms_per_optimized_click": (sum(r["ms"] for r in optimized)
                                       / max(len(optimized), 1)),
            "early_stops": {s: sum(r["stop"] == s for r in records)
                            for s in ("clicks", "iou")},
            "protocol": out["protocol"], "note": out["note"],
            "launches": total, "b_backward_launches": bwd_total, **gate}
        print("brs_run", mode, json.dumps(runs[mode]))
    res["runs"] = runs

    # (e) f-BRS on drawn LoftUp and JBU probes: D and E under autograd,
    # against the same objective with the plain version swapped in
    swaps = {"loftup": (attention, "_mha_cuda",
                        lambda q, k, v, scale, plan: attention._mha_plain(
                            q, k, v, scale), "mha"),
             "jbu_featup": (jbu, "_jbu_cuda", jbu._jbu_plain, "jbu_filter")}
    upsamplers = {}
    for name, (module, attr, plain, kernel) in swaps.items():
        cfg_u = dict(flagship_config(size), upsampler_cfg=UPSAMPLERS[name])
        drawn = init_params(iSegProbeModel(**cfg_u), seed=0).eval()
        calibrate_classifier(torch, drawn, size[0], FAMILY_POSITIVE_SHARE)
        img, gt = scene(3, size)
        p = brs.get_predictor(drawn, "f-BRS-B", zoom_in_params=zoom,
                              lbfgs_params={"maxfun": BRS_UPSAMPLER_MAXFUN})
        p.set_input_image(img)
        clicker = Clicker(gt_mask=gt)
        clicker.make_next_click(np.zeros(gt.shape, bool))
        probs = p.get_prediction(clicker)
        clicker.make_next_click(probs > TRAINED_THRESH)
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        with _Capture(brs, run=True) as cap:
            probs = p.get_prediction(clicker)
        click_ms = 1e3 * (time.perf_counter() - t0)
        click_launches = {k: v for k, v in counters().items() if v}
        if not click_launches.get(kernel):
            fail(f"f-BRS on {name} launched no {kernel}: {click_launches}")
        x = brs_seeded_x("f-BRS-B", p.opt_data.size)
        zero_counters()
        value, grad, *_ = cap.func.value_and_grad(x)
        eval_launches = {k: v for k, v in counters().items() if v}
        saved = getattr(module, attr)
        setattr(module, attr, plain)
        try:
            zero_counters()
            p_value, p_grad, *_ = cap.func.value_and_grad(x)
            plain_launches = counters()[kernel]
        finally:
            setattr(module, attr, saved)
        value, p_value = float(value), float(p_value)
        scale = float(p_grad.abs().max())
        rec = {"kernel": kernel, "evaluations": cap.func.n_evals,
               "click_ms": click_ms, "click_launches": click_launches,
               "evaluation_launches": eval_launches,
               "plain_evaluation_kernel_launches": plain_launches,
               "value": value, "plain_value": p_value,
               "value_rel_err": abs(value - p_value) / abs(p_value),
               "grad_err": float((grad - p_grad).abs().max()) / scale,
               "ms_per_evaluation": _host_ms(
                   lambda: _one_evaluation(cap.func, x), reps=3)}
        print("brs_upsampler", name, json.dumps(rec))
        if (rec["value_rel_err"] > BRS_UPSAMPLER_TOL
                or rec["grad_err"] > BRS_UPSAMPLER_TOL):
            fail(f"f-BRS on {name}: kernel {kernel} under autograd differs "
                 f"from its plain version: {rec}")
        if not np.isfinite(probs).all():
            fail(f"f-BRS on {name} gave non-finite probabilities")
        upsamplers[name] = rec
        launches[f"brs_fBRS_{name}"] = expected(**click_launches)
        del drawn, p, cap
        torch.cuda.empty_cache()
    res["upsamplers"] = upsamplers

    # (f) CropsPredictor against the transform chains on DAVIS' 854x480
    # frames: [Crops, SigmoidForPred, AddHorizontalFlip] averages the
    # flip's logits, as the predictor does (the gate: clicks equal, IoUs
    # within LOOP_IOU_TOL); [Crops, AddHorizontalFlip, SigmoidForPred]
    # averages its probabilities, which in the tiles' overlap can put a
    # pixel on the other side of the threshold (reported: each object's
    # first differing click, the IoUs' largest difference before it). Then
    # the click-model ensemble against JAX's
    davis = evaluate_cli.get_dataset("DAVIS", cfg)
    chains = {"predictor": None,
              "chain": [Crops(BRS_CROP_TILE), SigmoidForPred(),
                        AddHorizontalFlip()],
              "chain_prob_average": [Crops(BRS_CROP_TILE),
                                     AddHorizontalFlip(), SigmoidForPred()]}
    crops = {}
    for kind, transforms in chains.items():
        if transforms is None:
            predictor = CropsPredictor(model, crop_size=BRS_CROP_TILE,
                                       net_clicks_limit=TRAINED_CLICKS)
        else:
            predictor = TransformChainPredictor(
                model, transforms=transforms,
                net_clicks_limit=TRAINED_CLICKS)
        clicks: list = []
        zero_counters()
        t0 = time.time()
        ious, _ = evaluate_dataset(davis, predictor, clicks=clicks,
                                   max_iou_thr=TRAINED_TARGET,
                                   pred_thr=TRAINED_THRESH,
                                   max_clicks=TRAINED_CLICKS)
        wall = time.time() - t0
        n_clicks = sum(len(a) for a in ious)
        crops[kind] = {"ious": ious, "clicks": clicks,
                       "launches": counters(), "n_clicks": n_clicks,
                       "ms_per_click": 1e3 * wall / n_clicks}
        if kind == "predictor":
            tiles = len(predictor._offsets)
        if crops[kind]["launches"] != expected(**{
                k: v * n_clicks for k, v in per_forward.items()}):
            fail(f"Crops {kind} launched {crops[kind]['launches']}")
        launches[f"crops_{kind}"] = crops[kind]["launches"]
    pc = crops["predictor"]
    compared = {}
    for kind in ("chain", "chain_prob_average"):
        first, err = [], 0.0
        for a_c, b_c, a_i, b_i in zip(pc["clicks"], crops[kind]["clicks"],
                                      pc["ious"], crops[kind]["ious"]):
            k = next((j for j, (a, b) in enumerate(zip(a_c, b_c))
                      if tuple(a) != tuple(b)), None)
            if k is None and len(a_c) != len(b_c):
                k = min(len(a_c), len(b_c))
            upto = min(len(a_i), len(b_i)) if k is None else k
            if upto:
                err = max(err, float(np.abs(a_i[:upto] - b_i[:upto]).max()))
            first.append(None if k is None else k + 1)
        compared[kind] = {"first_differing_click": first,
                          "max_iou_diff_before": err,
                          "ms_per_click": crops[kind]["ms_per_click"]}
    gate = compared["chain"]
    if any(gate["first_differing_click"]) or \
            gate["max_iou_diff_before"] > LOOP_IOU_TOL:
        fail(f"CropsPredictor parts from the logit-averaging chain: {gate}")
    res["crops"] = {"frames": len(davis), "tiles": tiles,
                    "tile": list(BRS_CROP_TILE), "clicks": pc["n_clicks"],
                    "predictor_ms_per_click": pc["ms_per_click"],
                    **compared}
    print("brs_crops", json.dumps(res["crops"]))
    members = [eval_load(torch, Path(TRAINED_CKPTS["flagship"]).parent / c,
                         torch.float32, size)[0] for c in BRS_ENSEMBLE]
    ensemble = brs.get_predictor(
        (members[-1], members), zoom_in_params=zoom,
        predictor_params={"net_clicks_limit": TRAINED_CLICKS})
    clicks = []
    zero_counters()
    ious, wall = evaluate_dataset(data, ensemble, clicks=clicks,
                                  max_iou_thr=TRAINED_TARGET,
                                  pred_thr=TRAINED_THRESH,
                                  max_clicks=TRAINED_CLICKS)
    n_clicks = sum(len(a) for a in ious)
    if counters() != expected(**{k: v * n_clicks
                                 for k, v in per_forward.items()}):
        fail(f"the ensemble launched {counters()} for {n_clicks} clicks")
    launches["ensemble"] = counters()
    res["ensemble"] = {
        "members": list(BRS_ENSEMBLE), "clicks": n_clicks,
        "ms_per_click": 1e3 * wall / n_clicks,
        **against_fixture(ious, clicks, fx["f_ens_ious"], fx["f_ens_n"],
                          fx["f_ens_clicks"], "click-model ensemble",
                          TRAINED_MAX_DIVERGED)}
    print("brs_ensemble", json.dumps(res["ensemble"]))
    del members, ensemble

    # (g) A, B, D and E under autograd at the BRS paths' batch-1 shapes
    res["autograd"] = [
        autograd_case(torch, F, "mha_qkv", (1, 1025, 1152), 31, reps=5),
        autograd_case(torch, F, "layernorm", (1, 1025, 384), 32, reps=5,
                      b_affine=True),
        autograd_case(torch, F, "mha", ((1, 64 * 448, 4, 101),
                                        (1, 1024, 4, 101)), 33, reps=2),
        autograd_case(torch, F, "jbu_filter", (1, 512, 512, 384), 34,
                      reps=2)]
    for c in res["autograd"]:
        print("brs_autograd", json.dumps(c))
    if not all(c["ok"] for c in res["autograd"]):
        fail(f"a kernel under autograd at batch 1 fails: "
             f"{[c for c in res['autograd'] if not c['ok']]}")
    res["path_launches"] = launches
    res["backward_launches"] = bwd_launches
    del model
    torch.cuda.empty_cache()
    return res


# published weights on the card (phase 11j): the converters' fixture
# (tests/test_torch_convert.py --export: the seeds, keys and shapes of the
# full-width state dicts drawn in their published layouts, JAX's outputs on
# them as 4096 sampled entries and a norm, JAX's first train-step loss with
# the drawn DINOv2), the drawn inputs' seed, the gates and the shapes the
# phase times. Gates: (a) the reference-layout round trip's params bitwise,
# trajectories equal to the unconverted checkpoint's and NoC equal to JAX's
# (CONVERTED_NOC, the fixture's, to 4 places); (b) the hub-layout round
# trip bitwise, its two train steps' losses bitwise the steps without it,
# the drawn backbone's first loss within CONVERTED_STEP_RTOL of JAX's (the
# bound of the full-width steps so far); (c) padded against unpadded f32
# logits within CONVERTED_LOGIT_TOL of their scale (exact zeros added in
# another summation order), the bf16 loops' NoC within LOFTUP_BF16_NOC_TOL
# of JAX's f32 NoC on the fixture's objects; (d) fused against unfused f32
# logits within CONVERTED_LOGIT_TOL, clicks equal and IoUs within
# LOOP_IOU_TOL; (e) the card's outputs against JAX's samples within
# CONVERTED_OUT_TOL of their largest magnitude (and their norms
# relatively): 1e-3 for the backbones and the text tower (FORWARD_RTOL,
# 12 f32 blocks), 1e-4 for LiFT (convolutions), 5e-3 for LoftUp (an ulp of
# a Fourier phase at frequencies up to e^10 moves a feature by ~1e-3,
# tests/test_torch_upsamplers.py)
CONVERTED_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
                     / "fixtures" / "converted_weights.npz")
CONVERTED_NOC = (3.2821, 3.4615, 4.3590)
CONVERTED_STEP_RTOL = 5.9e-6
CONVERTED_LOGIT_TOL = 1e-5
LOFTUP_BF16_NOC_TOL = 0.1
# the fused head's reason to exist: LoftUp's [B, H, W, C] map is never held
# whole, so its forward's peak above the resident model stays below this
# share of the unfused one's (a quarter measured at 448², B=4 and 16)
FUSED_PEAK_SHARE = 0.5
CONVERTED_OUT_TOL = {"dino": 1e-3, "clip": 1e-3, "clip_text": 1e-3,
                     "lift": 1e-4, "loftup": 5e-3}
CONVERTED_BATCH = 4
CONVERTED_LAUNCHES = {
    "dino": {"mha_qkv": 11, "layernorm": 23},
    "clip": {"mha_qkv": 11, "layernorm": 25},
    "clip_text": {"layernorm": 12 * 2 + 1},
    "lift": {},
    # 224², monolithic: ChannelNorm, the stem's norm, 2 layers of 3 norms
    # and one D, the transformer's final norm
    "loftup": {"layernorm": 1 + 1 + 2 * 3 + 1, "mha": 2},
}


def same_click_lists(a, b) -> bool:
    """Two runs' per-object clicks, (y, x, positive) rows, equal."""
    return len(a) == len(b) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def fixture_state_dict(torch, fx, name: str) -> dict:
    """The fixture's state dict ``name`` redrawn from its seed, keys and
    shapes (``utils/drawn_weights.draw_state_dict``), its SHA-256 checked
    against the export's."""
    from isegprobe_torch.utils.drawn_weights import draw_state_dict

    dims = np.split(fx[f"{name}_shapes"], np.cumsum(fx[f"{name}_ndims"])[:-1])
    layout = [(str(k), tuple(int(d) for d in s))
              for k, s in zip(fx[f"{name}_keys"], dims)]
    sd = draw_state_dict(layout, int(fx[f"{name}_seed"]),
                         getattr(torch, str(fx[f"{name}_dtype"])))
    digest = hashlib.sha256()
    for k, v in sd.items():
        digest.update(k.encode())
        digest.update(v.contiguous().numpy().tobytes())
    if digest.hexdigest() != str(fx[f"{name}_digest"]):
        fail(f"{name}: the redrawn state dict differs from the export's "
             "(numpy's generator moved?)")
    return sd


def against_samples(torch, got, fx, name: str) -> dict:
    """The card's output ``got`` against the fixture's JAX samples: shape
    equal, sampled entries within CONVERTED_OUT_TOL of their largest
    magnitude, the norm within it relatively."""
    tol = CONVERTED_OUT_TOL[name]
    got = got.detach().float().cpu().numpy()
    if list(got.shape) != [int(v) for v in fx[f"{name}_out_shape"]]:
        fail(f"{name}: output {got.shape}, JAX's "
             f"{fx[f'{name}_out_shape']}")
    want = fx[f"{name}_out_val"]
    err = float(np.abs(got.reshape(-1)[fx[f"{name}_out_idx"]] - want).max())
    scale = float(np.abs(want).max())
    norm = float(np.linalg.norm(got.astype(np.float64)))
    norm_err = abs(norm / float(fx[f"{name}_out_norm"]) - 1)
    rec = {"shape": list(got.shape), "max_abs_err": err, "scale": scale,
           "rel_err": err / scale, "norm_rel_err": norm_err, "tol": tol,
           "finite": bool(np.isfinite(got).all())}
    if not rec["finite"] or err > tol * scale or norm_err > tol:
        fail(f"{name}: the card's output differs from JAX's: {rec}")
    return rec


def converted_weights_phase(torch, F) -> dict:
    """Main paths of published weights (phase 11j of the module docstring):
    ``python -m isegprobe_torch.scripts.convert_reference_checkpoint`` and
    ``convert_weights`` (their ``main``), ``PRETRAINED_MODELS`` in the
    trainer, LoftUp's padded layout and fused head through
    ``load_model_for_eval``'s ``mxu_pad`` / ``fuse_hr_head``, the raw
    upsampler files through ``upsampler_path``, the CLIP text tower and its
    tokenizer; kernels A, B (with ``real``) and D at these paths' shapes
    against their plain versions."""
    import warnings

    import isegprobe_torch.evaluate as evaluate_cli
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.models.convert import (
        load_jax_params,
        load_upsampler_params,
        restrict_to_module,
    )
    from isegprobe_torch.models.featurizers.clip_tokenizer import \
        ClipTokenizer
    from isegprobe_torch.models.featurizers.maskclip import CLIPTextEncoder
    from isegprobe_torch.models.probe_model import BACKBONES, synthetic_config
    from isegprobe_torch.models.upsamplers.lift import LiFTUpsampler
    from isegprobe_torch.models.upsamplers.loftup import LoftUpUpsampler
    from isegprobe_torch.ops import attention, layernorm
    from isegprobe_torch.scripts import convert_reference_checkpoint
    from isegprobe_torch.scripts import convert_weights
    from isegprobe_torch.utils import drawn_weights
    from isegprobe_torch.utils.serialization import (
        load_checkpoint,
        msgpack_restore,
    )

    t_phase = time.time()
    fx = np.load(CONVERTED_FIXTURE)
    tmp = Path(scratch()) / "converted"
    tmp.mkdir(exist_ok=True)
    res: dict = {}
    paths: dict = {}

    def same_tree(got, want, what):
        for (pa, a), (pb, b) in zip(_flat(got), _flat(want)):
            if pa != pb or not np.array_equal(np.asarray(a), np.asarray(b)):
                fail(f"{what}: leaf {pa} / {pb} differs")
        if len(list(_flat(got))) != len(list(_flat(want))):
            fail(f"{what}: the trees have other leaves")

    # (a) the trained flagship in the reference's torch layout, converted
    # and evaluated through the command line's functions
    t0 = time.time()
    params, config, _ = load_checkpoint(TRAINED_CKPTS["flagship"])
    ref_path, conv = tmp / "reference.pth", tmp / "converted.ckpt"
    torch.save(drawn_weights.reference_checkpoint(params, config["params"]),
               ref_path)
    convert_reference_checkpoint.main(["--input", str(ref_path),
                                       "--output", str(conv)])
    got_params, got_config, _ = load_checkpoint(conv)
    same_tree(got_params, params, "converted reference checkpoint")
    runs = {}
    for name, ckpt in (("converted", conv),
                       ("unconverted", TRAINED_CKPTS["flagship"])):
        # print_ious=false: lanes stop at the target IoU (the NoC is read
        # at each object's first crossing, so it is the all-clicks one)
        cfg = evaluate_cli.parse_args([f"checkpoint={ckpt}",
                                       "datasets=Synthetic",
                                       "eval_mode=fixed448",
                                       "device_loop=true", "device_batch=8",
                                       "print_ious=false"])
        model, _ = eval_load(torch, ckpt, torch.float32)
        clicks: list = []
        zero_counters()
        out = evaluate_cli.evaluate(cfg, model, clicks=clicks)
        launches = counters()
        steps = launches["edt_row_envelope"]
        if not steps or launches != expected(**{
                k: v * steps for k, v in PER_STEP.items()}):
            fail(f"{name} checkpoint's loop launched {launches}")
        runs[name] = (out, clicks, launches)
        del model
    (a_out, a_clicks, a_launches), (b_out, b_clicks, _) = (
        runs["converted"], runs["unconverted"])
    if not (same_click_lists(a_clicks, b_clicks) and all(
            np.array_equal(x, y) for x, y in zip(a_out["all_ious"],
                                                 b_out["all_ious"]))):
        fail("the converted checkpoint clicks otherwise than the "
             "unconverted one")
    noc = [float(v) for v in a_out["noc"]]
    if any(abs(a - b) > 5e-5 for a, b in zip(noc, CONVERTED_NOC)):
        fail(f"converted checkpoint NoC {noc}, JAX's {CONVERTED_NOC}")
    res["reference"] = {"objects": len(a_out["all_ious"]), "noc": noc,
                        "jax_noc": list(CONVERTED_NOC),
                        "loop_s": a_out["elapsed"],
                        "launches": a_launches, "s": time.time() - t0}
    paths["converted_reference_loop"] = a_launches
    print("converted_reference", json.dumps(res["reference"]))

    # (b) the flagship's frozen backbone in the hub's layout, plain and
    # chunked, converted back bitwise; two train steps with and without it
    t0 = time.time()
    argv = ["model=synthetic_dinov2_noup", "dataloader.workers=0",
            f"exp_path={scratch()}"]
    vit = initial_tree(argv)["backbone"]["model"]
    weights = tmp / "dinov2_vits14.msgpack"
    for chunks in (0, 4):
        hub = tmp / f"hub{chunks}.pth"
        torch.save(drawn_weights.vit_state_dict(vit, True, chunks), hub)
        convert_weights.main(["--kind", "dinov2", "--input", str(hub),
                              "--output", str(weights)])
        same_tree(msgpack_restore(weights.read_bytes()), vit,
                  f"DINOv2 hub round trip (chunks {chunks})")
    step_fx = np.load(TRAIN_FIXTURE)

    def steps_of(extra, n):
        trainer = build(argv + extra)
        batch = trainer._upload({k: step_fx[k] for k in ("images", "points",
                                                          "instances")})
        zero_counters()
        # cuDNN's default weight-gradient algorithms add in a varying
        # order, which moves a second step's loss in its last bits: the
        # deterministic ones make two runs of a step comparable bit for bit
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            losses = [float(trainer._step(batch, 0)[0]) for _ in range(n)]
        finally:
            torch.backends.cudnn.deterministic = deterministic
        torch.cuda.synchronize()
        launches = counters()
        if launches != expected(**{k: n * v for k, v in
                                   FORWARD_LAUNCHES["flagship"].items()}):
            fail(f"pretrained train steps launched {launches}")
        trainer.shutdown()
        return losses, launches

    plain, _ = steps_of([], 2)
    pre, launches = steps_of(
        [f"PRETRAINED_MODELS.DINOV2_VITS14={weights}"], 2)
    if plain != pre:
        fail(f"steps with the round-tripped backbone {pre} differ from the "
             f"steps without it {plain}")
    hub = tmp / "drawn_dinov2.pth"
    torch.save(fixture_state_dict(torch, fx, "dinov2"), hub)
    convert_weights.main(["--kind", "dinov2", "--input", str(hub),
                          "--output", str(weights)])
    (drawn,), _ = steps_of([f"PRETRAINED_MODELS.DINOV2_VITS14={weights}"], 1)
    want = float(fx["dinov2_step_loss"])
    err = abs(drawn / want - 1)
    if err > CONVERTED_STEP_RTOL:
        fail(f"the drawn DINOv2's first step loss {drawn} differs from "
             f"JAX's {want} by {err} > {CONVERTED_STEP_RTOL}")
    res["pretrained"] = {"losses": plain, "drawn_loss": drawn,
                         "jax_cpu_drawn_loss": want, "loss_rel_err": err,
                         "launches": launches, "s": time.time() - t0}
    paths["pretrained_train_steps"] = launches
    print("converted_pretrained", json.dumps(res["pretrained"]))

    # (c, d) the trained LoftUp padded and fused: logits, forward ms and
    # the loops on the fixture's objects
    t0 = time.time()
    rng = np.random.default_rng(7)
    b = CONVERTED_BATCH
    image = torch.from_numpy(rng.random((b, 448, 448, 4), np.float32)).cuda()
    pts = np.full((b, 4, 3), -1.0, np.float32)
    pts[:, 0] = (200, 220, 0)
    pts[:, 2] = (90, 300, 1)
    pts = torch.from_numpy(pts).cuda()
    layouts = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LoftUp's missing upsampler_path
        for dtype in ("float32", "bfloat16"):
            # auto: unpadded in f32, padded in bf16 (checked below)
            for key, kw in (("unpadded", dict(mxu_pad=False)),
                            ("padded", dict(mxu_pad=True)),
                            ("auto", {}),
                            ("fused", dict(mxu_pad=False,
                                           fuse_hr_head=True))):
                if dtype == "bfloat16" and key in ("padded", "fused"):
                    continue
                layouts[dtype, key] = eval_load(
                    torch, TRAINED_CKPTS["loftup"], getattr(torch, dtype),
                    **kw)[0]
    if not (layouts["bfloat16", "auto"].upsampler.mxu_pad
            and not layouts["float32", "auto"].upsampler.mxu_pad):
        fail("mxu_pad=auto must pad in bf16 and not in f32")
    layouts["bfloat16", "padded"] = layouts["bfloat16", "auto"]
    fwd = {}
    with torch.inference_mode():
        for (dtype, key), model in layouts.items():
            if key == "auto":  # bf16: the padded model itself
                continue
            zero_counters()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            logits = model(image, pts)["instances"].float()
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - resident) / 2**20
            launches = counters()
            if launches != expected(**FORWARD_LAUNCHES["loftup"]):
                fail(f"LoftUp {dtype} {key} forward launched {launches}")
            ms = time_ms(torch, lambda: model(image, pts), reps=2,
                         rounds=3, graph=False, warmup=1)[0]
            fwd[dtype, key] = (logits, ms, peak_mb)
            paths[f"loftup_{key}_{dtype}_forward"] = launches
    layout_rec = {}
    for dtype in ("float32", "bfloat16"):
        ref_logits, ref_ms, ref_mb = fwd[dtype, "unpadded"]
        scale = float(ref_logits.abs().max())
        rec = {"unpadded_ms": ref_ms, "padded_ms": fwd[dtype, "padded"][1],
               "unpadded_peak_mb": ref_mb,
               "padded_peak_mb": fwd[dtype, "padded"][2],
               "logit_scale": scale}
        rec["padded_speedup"] = rec["unpadded_ms"] / rec["padded_ms"]
        rec["padded_max_abs_err"] = float(
            (fwd[dtype, "padded"][0] - ref_logits).abs().max())
        if dtype == "float32":
            rec["fused_ms"] = fwd[dtype, "fused"][1]
            rec["fused_peak_mb"] = fwd[dtype, "fused"][2]
            if rec["fused_peak_mb"] > FUSED_PEAK_SHARE * ref_mb:
                fail(f"the fused head's forward peaks at "
                     f"{rec['fused_peak_mb']:.1f} MB above the resident "
                     f"model, the unfused one's at {ref_mb:.1f}: not below "
                     f"{FUSED_PEAK_SHARE} of it")
            rec["fused_max_abs_err"] = float(
                (fwd[dtype, "fused"][0] - ref_logits).abs().max())
            for key in ("padded", "fused"):
                if rec[f"{key}_max_abs_err"] > CONVERTED_LOGIT_TOL * scale:
                    fail(f"LoftUp f32 {key} logits differ from the "
                         f"unpadded, unfused ones: {rec}")
        layout_rec[dtype] = rec
        print(f"trained LoftUp {dtype} B={b} at 448²: unpadded "
              f"{rec['unpadded_ms']:.2f} ms ({ref_mb:.1f} MB peak above the "
              f"resident model), padded {rec['padded_ms']:.2f} ms "
              f"({rec['padded_peak_mb']:.1f} MB) a forward"
              + (f", fused head {rec['fused_ms']:.2f} ms "
                 f"({rec['fused_peak_mb']:.1f} MB)" if "fused_ms" in rec
                 else ""))
    res["loftup_layouts"] = layout_rec
    del fwd

    sfx = dict(np.load(SYNTHETIC_FIXTURE))
    m = TRAINED_LOFTUP_OBJECTS
    mc = TRAINED_LOFTUP_CLICKS
    data = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, m))
    want_noc = compute_noc_metric(
        [sfx["loftup_ious"][i, :sfx["loftup_n"][i]] for i in range(m)],
        [0.8, 0.85, 0.9], mc)[0]
    per_step = expected(edt_row_envelope=1, **FORWARD_LAUNCHES["loftup"])
    loops = {}
    for dtype, key in (("float32", "unpadded"), ("float32", "fused"),
                       ("bfloat16", "auto"), ("bfloat16", "unpadded")):
        run = device_eval.make_device_evaluator(
            layouts[dtype, key], target_size=(448, 448), batch_size=b,
            max_clicks=mc, net_clicks_limit=mc, pred_thr=TRAINED_THRESH,
            target_iou=TRAINED_TARGET, record_clicks=True)
        clicks = []
        zero_counters()
        t1 = time.time()
        got = device_eval.evaluate_dataset_device(run, data, clicks=clicks)
        wall = time.time() - t1
        launches = counters()
        if launches != {k: v * run.steps for k, v in per_step.items()}:
            fail(f"LoftUp {dtype} {key} loop launched {launches}")
        noc = compute_noc_metric(got, [0.8, 0.85, 0.9], mc)[0]
        loops[dtype, key] = (got, clicks)
        rec = {"dtype": dtype, "layout": key, "batch": b, "objects": m,
               "steps": run.steps, "ms_per_step": 1e3 * wall / run.steps,
               "noc": noc, "jax_cpu_f32_noc": want_noc,
               "launches": launches}
        if dtype == "bfloat16":
            gap = max(abs(x - y) for x, y in zip(noc, want_noc))
            rec["noc_gap_to_jax_f32"] = gap
            rec["partings"] = []
            for i, c in enumerate(clicks):
                got_c = [tuple(int(v) for v in r) for r in c]
                want_c = [tuple(int(v) for v in r) for r in
                          sfx["loftup_clicks"][i, :sfx["loftup_n"][i]]]
                if got_c != want_c:
                    k = next((j for j, (p, q) in enumerate(zip(got_c, want_c))
                              if p != q), min(len(got_c), len(want_c)))
                    rec["partings"].append({"object": i, "click": k + 1})
            if gap > LOFTUP_BF16_NOC_TOL:
                fail(f"LoftUp bf16 {key} loop NoC {noc} differ from JAX's "
                     f"f32 {want_noc} by {gap} > {LOFTUP_BF16_NOC_TOL}")
        print("converted_loftup_loop", json.dumps(rec))
        res.setdefault("loftup_loops", []).append(rec)
        paths[f"loftup_{key}_{dtype}_loop"] = launches
    (u_ious, u_clicks), (f_ious, f_clicks) = (loops["float32", "unpadded"],
                                              loops["float32", "fused"])
    if not same_click_lists(u_clicks, f_clicks) or any(
            np.abs(np.asarray(x) - np.asarray(y)).max() > LOOP_IOU_TOL
            for x, y in zip(u_ious, f_ious)):
        fail("the fused head's loop clicks otherwise than the unfused one")
    del layouts, loops
    res["loftup_s"] = time.time() - t0

    # (e) drawn raw files in their published layouts on the card, against
    # JAX's outputs on the same drawn inputs
    t0 = time.time()
    rng = np.random.default_rng(int(fx["inputs_seed"]))
    # drawn in float64 and rounded, in the export's order
    inputs = {"image": rng.standard_normal((1, 224, 224, 3)),
              "source": rng.standard_normal((1, 16, 16, 384)),
              "guidance": rng.random((1, 224, 224, 3))}
    inputs = {k: torch.from_numpy(v.astype(np.float32)).cuda()
              for k, v in inputs.items()}
    outs = {}
    for name in ("dino", "clip"):
        sd = fixture_state_dict(torch, fx, name)
        src = tmp / f"{name}.pth"
        torch.save({"model": sd} if name == "dino" else sd, src)
        kind = {"dino": "dino", "clip": "clip"}[name]
        dst = tmp / f"{name}.msgpack"
        convert_weights.main(["--kind", kind, "--input", str(src),
                              "--output", str(dst)])
        script = "vit_noup" if name == "dino" else "maskclip_noup"
        btype = "vit" if name == "dino" else "mask_clip"
        module = BACKBONES[btype](
            **synthetic_config(script)["backbone_cfg"]["params"]).cuda()
        load_jax_params(module.model, restrict_to_module(
            msgpack_restore(dst.read_bytes()), module.model))
        outs[name] = (module, lambda m=module: m(inputs["image"]))
        if name == "clip":
            dst = tmp / "clip_text.msgpack"
            convert_weights.main(["--kind", "clip_text", "--input", str(src),
                                  "--output", str(dst)])
            text = load_jax_params(CLIPTextEncoder().cuda(),
                                   msgpack_restore(dst.read_bytes()))
            merges = drawn_weights.write_merges(
                tmp / "merges.txt.gz", [str(w) for w in fx["merge_words"]])
            ids = ClipTokenizer(str(merges))(
                [str(t) for t in fx["text_strings"]])
            if not np.array_equal(ids, fx["text_ids"]):
                fail("the tokenizer's ids differ from JAX's")
            ids = torch.from_numpy(ids).cuda()
            outs["clip_text"] = (text, lambda m=text: m(ids))
        del sd
    for name, cls in (("lift", LiFTUpsampler), ("loftup", LoftUpUpsampler)):
        src = tmp / f"{name}.pth"
        sd = fixture_state_dict(torch, fx, name)
        torch.save({"state_dict": sd} if name == "lift" else sd, src)
        module = load_jax_params(cls(n_dim=384).cuda(), load_upsampler_params(
            {"type": name, "params": {"upsampler_path": str(src)}}))
        outs[name] = (module, lambda m=module: m(inputs["source"],
                                                  inputs["guidance"]))
    samples = {}
    with torch.inference_mode():
        for name, (module, call) in outs.items():
            zero_counters()
            got = call()
            torch.cuda.synchronize()
            launches = counters()
            if launches != expected(**CONVERTED_LAUNCHES[name]):
                fail(f"{name} forward launched {launches}")
            samples[name] = dict(against_samples(torch, got, fx, name),
                                 launches=launches,
                                 ms=time_ms(torch, call, reps=3, rounds=3,
                                            graph=False)[0])
            paths[f"converted_{name}_forward"] = launches
            print("converted_features", name, json.dumps(samples[name]))
    res["drawn_files"] = samples
    res["drawn_s"] = time.time() - t0
    del outs

    # A, B (with real) and D at these paths' shapes against their plain
    # versions: the DINO and CLIP towers at 224², the text tower, and the
    # padded LoftUp at 448², B=4 (D at dh 128; B over 404 of 512 and 203
    # of 256 channels)
    t0 = time.time()
    checks = []
    checks += attention_case(torch, F, attention, 1, 197, 6, 64, "float32",
                             seed=90)
    checks += attention_case(torch, F, attention, 1, 197, 12, 64,
                             "float32", seed=91)
    checks.append(layernorm_case(torch, F, layernorm, (3, 77), 512,
                                 "float32", seed=92, eps=1e-5))
    seed = 93
    for dtype in ("float32", "bfloat16"):
        checks += cross_attention_case(torch, F, attention, b, 64 * 448,
                                       1024, 4, 128, dtype, seed=seed)
        for rows, d, real in (((64 * 448,), 512, 404),
                              ((68, 448), 256, 203)):
            checks.append(layernorm_case(torch, F, layernorm, (b, *rows), d,
                                         dtype, seed=seed + 1, eps=1e-5,
                                         real=real))
            seed += 2
    for c in checks:
        print("check", json.dumps(c))
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    res["kernels_s"] = time.time() - t0
    res["s"] = time.time() - t_phase
    seconds = {k: res[k]["s"] for k in ("reference", "pretrained")}
    seconds.update((k, res[k]) for k in ("loftup_s", "drawn_s", "kernels_s",
                                         "s"))
    print("converted_seconds", json.dumps(seconds))
    res["path_launches"] = paths
    res["checks"] = checks
    return res


# what a researcher's run leaves behind (phase 11k): the evaluate CLI with
# every output key on the GrabCut, Berkeley and DAVIS trees against the
# root CLI's files (isegprobe_torch/fixtures/eval_outputs.npz, from
# tests/test_torch_eval_outputs.py --export) and the 11h trajectories; the
# feature probe of the trained probes against the plain versions on the
# card (OUTPUTS_PLAIN_TOL of the map's scale; bf16: OUTPUTS_BF16_TOL) and
# against JAX's samples (OUTPUTS_FEAT_TOL; bf16: OUTPUTS_BF16_TOL); two
# short epochs of the flagship's train CLI with image dumps every
# OUTPUTS_DUMP_INTERVAL steps and without the dumps and the writer,
# OUTPUTS_PAIRS times each, interleaved. Every run draws the same clicks
# (0-3 a step, seeded by the epoch), so the runs' steps are the same work.
# The host clock of a step moves by a third between runs of one kind (the
# loader threads, the host's other tenants), so the gate takes the best of
# each kind's runs: the best median wall time of the steps that neither
# dump nor follow a dump, with dumps, must be at most OUTPUTS_STEP_NOISE
# times the best without. One more run of each kind under
# set_sync_debug_mode("warn") counts the synchronizing calls of each step:
# those steps must make exactly as many with dumps as without
OUTPUTS_FIXTURE = (Path(__file__).resolve().parent / "isegprobe_torch"
                   / "fixtures" / "eval_outputs.npz")
OUTPUTS_DATASETS = ("GrabCut", "Berkeley", "DAVIS")
OUTPUTS_KEYS = ("vis_preds=true", "save_feats=true", "save_feats_for_n_imgs=2",
                "save_ious=true", "iou_analysis=true")
OUTPUTS_PLAIN_TOL = 1e-4
OUTPUTS_FEAT_TOL = 1e-3
OUTPUTS_BF16_TOL = 0.05
OUTPUTS_FEAT_OBJECTS = 2
OUTPUTS_FEAT_REPS = 5
OUTPUTS_DUMP_INTERVAL = 4
OUTPUTS_EPOCH_LEN = 96
OUTPUTS_VAL_LEN = 8
OUTPUTS_STEP_NOISE = 1.25
# the evaluate CLI's profile_dir on the card (d): objects and clicks of the
# profiled host-protocol run
PROFILE_OBJECTS, PROFILE_CLICKS = 2, 3
OUTPUTS_PAIRS = 3
OUTPUTS_TAGS = sorted([
    "Losses/instance_loss", "Losses/nfl_k", "Losses/nfl_m_max",
    "Losses/overall", "States/learning_rate", "Metrics/AdaptiveIoU_ema_iou",
    "Metrics/AdaptiveIoU_iou_thresh", "Metrics/AdaptiveIoU", "Val/loss",
    "Val/AdaptiveIoU"])


class plain_kernels:
    """Kernels A, B and D computed by their plain versions on the card
    (their wrappers still count the calls): the plain-version forward."""

    def __enter__(self):
        from isegprobe_torch.ops import attention, layernorm

        self.saved = [(attention, "_mha_qkv_cuda"), (attention, "_mha_cuda"),
                      (layernorm, "_ln_cuda")]
        self.saved = [(m, a, getattr(m, a)) for m, a in self.saved]
        attention._mha_qkv_cuda = lambda qkv, heads, scale, plan: \
            attention._mha_qkv_plain(qkv, heads, scale, None)
        attention._mha_cuda = lambda q, k, v, scale, plan: \
            attention._mha_plain(q, k, v, scale)
        layernorm._ln_cuda = layernorm._ln_plain
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)


def _run_tags(dataset) -> list:
    """The vis callback's file tags of a dataset's objects, in order."""
    tags = []
    for i in range(len(dataset)):
        for n, _ in enumerate(dataset.get_sample(i).objects_ids):
            tags.append(f"{i}" if n == 0 else f"{i}_obj{n}")
    return tags


def _stop_at_target(ious, clicks, target: float) -> tuple:
    """A trajectory of every click cut where the early-stop protocol
    stops: the first click whose IoU reaches ``target``."""
    hit = np.flatnonzero(np.asarray(ious) >= target)
    n = int(hit[0]) + 1 if hit.size else len(ious)
    return np.asarray(ious[:n]), clicks[:n]


def outputs_eval_part(torch, fx) -> tuple:
    """(a) of phase 11k: the evaluate CLI with every output key; returns
    (record, launches)."""
    import pickle
    import re
    import shutil

    from isegprobe_torch import evaluate as evaluate_cli

    data_fx = dict(np.load(DATA_FIXTURE))
    logs = Path(scratch()) / "eval_outputs"
    common = [f"checkpoint={TRAINED_CKPTS['flagship']}", "eval_mode=fixed448",
              f"n_clicks={TRAINED_CLICKS}",
              *(f"DATASETS.{k}_PATH={DATA_TREES / v}"
                for k, v in DATA_PATH_KEYS.items())]
    cfg = evaluate_cli.parse_args([
        *common, f"datasets={','.join(OUTPUTS_DATASETS)}", *OUTPUTS_KEYS,
        f"logs_path={logs}"])
    clicks: dict = {}
    saves = []  # seconds of each feature dump's np.save (map to disk)
    real_save = np.save

    def timed_save(*a, **kw):
        t = time.perf_counter()
        real_save(*a, **kw)
        saves.append(time.perf_counter() - t)

    torch.cuda.synchronize()
    zero_counters()
    t0 = time.time()
    np.save = timed_save
    try:
        results = evaluate_cli.evaluate_all(cfg, clicks=clicks)
    finally:
        np.save = real_save
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_clicks = sum(len(a) for r in results for a in r["all_ious"])
    # a prediction (flip: one forward at batch 2) and the feature probe
    # (one forward at batch 1) a click
    want = expected(**{k: 2 * v * n_clicks for k, v in
                       FORWARD_LAUNCHES["flagship"].items()})
    launches = counters()
    if launches != want:
        fail(f"evaluate CLI with outputs launched {launches} for {n_clicks} "
             f"clicks, expected {want}")
    files = sorted(str(p.relative_to(logs)) for p in logs.rglob("*")
                   if p.is_file())
    named = sorted(re.sub(r"_\d{4}-\d\d-\d\d_\d\d:\d\d", "_DATE", f)
                   for f in files)
    if named != sorted(fx["card_files"]):
        missing = sorted(set(fx["card_files"]) - set(named))
        extra = sorted(set(named) - set(fx["card_files"]))
        fail(f"evaluate CLI outputs differ from the root CLI's: missing "
             f"{missing[:10]}, extra {extra[:10]}")
    feats_bytes = sum(p.stat().st_size for p in (logs / "feats").rglob("*")
                      if p.is_file())
    per = {}
    for out in results:
        name = out["dataset"]
        with open(logs / f"{name}_NoBRS_{TRAINED_CLICKS}_"
                  f"{out['model_name']}.pickle", "rb") as f:
            ious = pickle.load(f)["all_ious"]
        tags = _run_tags(evaluate_cli.get_dataset(name, cfg))
        json_err = 0.0
        for tag, traj in zip(tags, ious):
            for k, v in enumerate(traj):
                got = json.loads((logs / "predictions_vis" / name / "iou"
                                  / f"{tag}_{k}.json").read_text())["iou"]
                json_err = max(json_err, abs(got - float(v) * 100))
        if json_err > 1e-4:
            fail(f"{name}: a JSON IoU differs from the pickle's × 100 by "
                 f"{json_err}")
        cut = [_stop_at_target(a, c, TRAINED_TARGET)
               for a, c in zip(ious, clicks[name])]
        rec = against_fixture([c[0] for c in cut], [c[1] for c in cut],
                              data_fx[f"eval_{name}_ious"],
                              data_fx[f"eval_{name}_n"],
                              data_fx[f"eval_{name}_clicks"],
                              f"{name} evaluate CLI with outputs",
                              TRAINED_MAX_DIVERGED)
        per[name] = {"objects": len(ious), "json_vs_pickle_max_err": json_err,
                     "noc": list(out["noc"]), **rec}
    shutil.rmtree(logs / "feats")
    # ms a host click with the prediction dumps off and on, on GrabCut
    model, _ = eval_load(torch, TRAINED_CKPTS["flagship"], torch.float32)
    host = {}
    for key, extra in (("vis_off", []), ("vis_on", ["vis_preds=true"]),
                       ("vis_off_again", [])):
        run_cfg = evaluate_cli.parse_args([
            *common, "datasets=GrabCut", f"logs_path={logs}_{key}", *extra])
        out = evaluate_cli.evaluate(run_cfg, model, "GrabCut")
        n = sum(len(a) for a in out["all_ious"])
        host[key] = {"clicks": n, "ms_per_click": 1e3 * out["elapsed"] / n}
        shutil.rmtree(f"{logs}_{key}", ignore_errors=True)
    del model
    rec = {"wall_s": wall, "clicks": n_clicks, "launches": launches,
           "ms_per_click_with_outputs": 1e3 * wall / n_clicks,
           "feature_saves": len(saves), "feature_saves_s": sum(saves),
           "files": len(files), "feats_mb": feats_bytes / 2**20,
           "datasets": per, "host_click": host,
           "results_txt": (logs / "results.txt").read_text().splitlines()}
    print("outputs_eval", json.dumps(rec))
    return rec, launches


def outputs_feats_part(torch, fx) -> tuple:
    """(b) of phase 11k: the first-click feature probe of the trained
    flagship (f32, bf16) and LoftUp (f32) against the plain versions and
    JAX's samples, with exact launches; returns (record, launches)."""
    from isegprobe_torch.data.scenes import SceneDataset
    from isegprobe_torch.inference.clicker import Clicker
    from isegprobe_torch.inference.predictor import Predictor

    ds = SceneDataset(objects=slice(0, OUTPUTS_FEAT_OBJECTS))
    recs, total = [], expected()
    for name, dtype in (("flagship", torch.float32),
                        ("flagship", torch.bfloat16),
                        ("loftup", torch.float32)):
        bf16 = dtype == torch.bfloat16
        model, _ = eval_load(torch, TRAINED_CKPTS[name], dtype)
        pred = Predictor(model, target_size=(448, 448),
                         prob_thresh=TRAINED_THRESH)
        for k in range(OUTPUTS_FEAT_OBJECTS):
            sample = ds.get_sample(k)
            gt = sample.gt_mask(sample.objects_ids[0])
            pred.set_input_image(sample.image)
            clicker = Clicker(gt_mask=gt)
            clicker.make_next_click(np.zeros(gt.shape, bool))
            torch.cuda.synchronize()
            zero_counters()
            _, feats = pred.get_lowres_highres_feats(clicker)
            torch.cuda.synchronize()
            launches = counters()
            if launches != expected(**FORWARD_LAUNCHES[name]):
                fail(f"{name} feature probe launched {launches}, expected "
                     f"{expected(**FORWARD_LAUNCHES[name])}")
            total = {kk: total[kk] + launches[kk] for kk in KERNELS}
            with plain_kernels():
                _, plain = pred.get_lowres_highres_feats(clicker)
            t0 = time.perf_counter()
            for _ in range(OUTPUTS_FEAT_REPS):
                pred.get_lowres_highres_feats(clicker)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / OUTPUTS_FEAT_REPS
            rec = {"model": name, "dtype": "bfloat16" if bf16 else "float32",
                   "object": k, "ms_per_call": ms,
                   "launches": {kk: v for kk, v in launches.items() if v}}
            for m in ("LowRes", "HighRes"):
                x = feats[m].float()
                if tuple(x.shape) != tuple(fx[f"feats_{name}_{k}_{m}_shape"]) \
                        or not bool(torch.isfinite(x).all()):
                    fail(f"{name} {m}: bad map of shape {tuple(x.shape)}")
                scale = float(x.abs().max())
                plain_err = float((x - plain[m].float()).abs().max()) / scale
                host = x.cpu().numpy().ravel()
                jscale = float(fx[f"feats_{name}_{k}_{m}_stats"][0])
                fx_err = float(np.abs(
                    host[fx[f"feats_{name}_{k}_{m}_idx"]]
                    - fx[f"feats_{name}_{k}_{m}_vals"]).max()) / jscale
                plain_tol = OUTPUTS_BF16_TOL if bf16 else OUTPUTS_PLAIN_TOL
                fx_tol = OUTPUTS_BF16_TOL if bf16 else OUTPUTS_FEAT_TOL
                if plain_err > plain_tol:
                    fail(f"{name} {rec['dtype']} {m}: {plain_err} of its "
                         f"scale from the plain-version forward")
                if fx_err > fx_tol:
                    fail(f"{name} {rec['dtype']} {m}: {fx_err} of JAX's "
                         f"scale from JAX's samples")
                rec[m] = {"shape": list(x.shape), "scale": scale,
                          "plain_rel_err": plain_err,
                          "jax_rel_err": fx_err}
            recs.append(rec)
            print("outputs_feats", json.dumps(rec))
        del model, pred
    return recs, total


def outputs_train_run(torch, key: str, rep, syncs: dict | None = None):
    """One run of (c) of phase 11k: two short epochs of the flagship's
    train CLI, ``key`` "dumps" (image dumps every OUTPUTS_DUMP_INTERVAL
    steps, the writer at every step) or "off" (neither), every step's
    launches checked. With ``syncs`` (a dict) the run goes under
    ``set_sync_debug_mode("warn")`` and ``syncs[g]`` is the number of
    synchronizing calls within the wall time of training step ``g`` (an
    epoch's last step is left out: its read falls after the loop). Returns
    (trainer, launches by kind)."""
    import warnings

    per_step = {"train": [], "val": []}
    exp = Path(scratch()) / f"outputs_train_{key}_{rep}"
    argv = ["model=synthetic_dinov2_noup", "training_params.epochs=2",
            f"dataloader.workers={TRAIN_WORKERS}", f"exp_path={exp}",
            f"epoch_len={OUTPUTS_EPOCH_LEN}",
            f"val_epoch_len={OUTPUTS_VAL_LEN}", "tb_dump_period=1",
            "image_dump_interval="
            f"{0 if key == 'off' else OUTPUTS_DUMP_INTERVAL}"]
    checker = step_checker(f"outputs {key}", FORWARD_LAUNCHES["flagship"],
                           per_step)
    caught: list = []
    steps_per_epoch = OUTPUTS_EPOCH_LEN // TRAIN_BATCH

    def on_step(kind, index, num_iters):
        checker(kind, index, num_iters)
        if syncs is not None and kind == "train":
            # the calls since the last step's launch: the read of the step
            # before that one (with its dump), this step's upload and launch
            # -- all within the wall time of step index - 1
            if index % steps_per_epoch:
                syncs[index - 1] = sum("synchroniz" in str(w.message)
                                       for w in caught)
            caught.clear()

    trainer = build(argv, on_step=on_step)
    if key == "off":
        trainer.cfg.LOGS_PATH = None
    torch.cuda.synchronize()
    zero_counters()
    if syncs is None:
        trainer.run(2, validation=True)
    else:
        with warnings.catch_warnings(record=True) as log:
            warnings.simplefilter("always")
            caught = log
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trainer.run(2, validation=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    trainer.shutdown()
    return trainer, {kind: {k: sum(c[k] for c in per_step[kind])
                            for k in KERNELS} for kind in per_step}


def outputs_train_part(torch) -> tuple:
    """(c) of phase 11k: two short epochs of the flagship's train CLI with
    and without image dumps and writer, OUTPUTS_PAIRS times each,
    interleaved, then once more each counting the synchronizing calls;
    returns (record, launches of each kind's first run)."""
    from isegprobe_torch.data import image_io
    from isegprobe_torch.utils.log import read_scalars

    runs, total = {}, {}
    quiet_ms = {"off": [], "dumps": []}
    quiet_dev = {"off": [], "dumps": []}
    for rep in range(OUTPUTS_PAIRS):
        for key in ("off", "dumps"):
            t0 = time.time()
            trainer, launches = outputs_train_run(torch, key, rep)
            wall = time.time() - t0
            st = trainer.stats
            steps = len(st["num_iters"])
            per_epoch = steps // 2
            # a dump step's panel is drawn in the step after it (the
            # deferred read): the steps that neither dump nor follow a dump
            quiet = [i for i in range(steps)
                     if (i % per_epoch) % OUTPUTS_DUMP_INTERVAL not in (0, 1)]
            walls = np.asarray(st["step_wall_s"]) * 1e3
            dev = np.asarray(st["step_device_ms"])
            quiet_ms[key].append(float(np.median(walls[quiet])))
            quiet_dev[key].append(float(np.median(dev[quiet])))
            if rep:
                continue
            total[key] = launches
            runs[key] = {
                "steps": steps, "wall_s": wall,
                "ms_per_step_median": float(np.median(walls)),
                "device_ms_per_step_median": float(np.median(dev)),
                "device_busy_share": float(dev.sum() / walls.sum()),
                "quiet_device_busy_share": float(dev[quiet].sum()
                                                 / walls[quiet].sum())}
            run = Path(trainer.cfg.EXP_PATH)
            if key == "off":
                if (run / "vis" / "train").exists() and any(
                        (run / "vis" / "train").iterdir()):
                    fail("image_dump_interval=0 wrote dumps")
                continue
            if not (run / "logs" / "train.log").read_text().count(
                    "val loss") == 2:
                fail(f"train.log of {run} lacks the epochs' lines")
            if not (run / "dinov2_noup.py").exists():
                fail(f"{run} lacks the model script's copy")
            dumps = sorted((run / "vis" / "train").iterdir())
            want = [f"{g:06d}_instance_segmentation.jpg"
                    for g in range(steps) if g % OUTPUTS_DUMP_INTERVAL == 0]
            if [p.name for p in dumps] != want:
                fail(f"image dumps {[p.name for p in dumps]}, expected "
                     f"{want}")
            shape = image_io.read_rgb(dumps[0]).shape
            if shape != (224, 3 * 224, 3):
                fail(f"an image dump is {shape}")
            t0 = time.perf_counter()
            panel = np.zeros((448, 3 * 448, 3), np.uint8)
            panel[:, :448] = image_io.read_rgb(dumps[0])[:, :224].repeat(
                2, 0).repeat(2, 1)
            for _ in range(5):
                image_io.encode_jpeg(panel, 85)
            runs[key]["encode_448_panel_ms"] = 1e3 * (
                time.perf_counter() - t0) / 5
            scalars = read_scalars(run / "logs")
            if sorted(scalars) != OUTPUTS_TAGS:
                fail(f"event tags {sorted(scalars)}, expected "
                     f"{OUTPUTS_TAGS}")
            if [s for s, _ in scalars["Losses/overall"]] != list(
                    range(steps)) or [s for s, _ in scalars["Val/loss"]] \
                    != [0, 1]:
                fail("event steps differ from the JAX trainer's")
            runs[key]["dumps"] = len(dumps)
            runs[key]["events_bytes"] = sum(
                p.stat().st_size for p in (run / "logs").glob("events.*"))
    ratio = min(quiet_ms["dumps"]) / min(quiet_ms["off"])
    runs["quiet_steps"] = {
        "steps": len(quiet), "runs": OUTPUTS_PAIRS,
        "ms_medians_dumps": quiet_ms["dumps"],
        "ms_medians_off": quiet_ms["off"],
        "device_ms_medians_dumps": quiet_dev["dumps"],
        "device_ms_medians_off": quiet_dev["off"],
        "dumps_over_off": ratio,
        "off_spread": max(quiet_ms["off"]) / min(quiet_ms["off"])}
    if ratio > OUTPUTS_STEP_NOISE:
        fail(f"with dumps the best median of the steps that neither dump "
             f"nor follow a dump is {ratio:.3f}x the best without dumps "
             f"(medians {quiet_ms['dumps']} against {quiet_ms['off']} ms)")
    syncs = {"off": {}, "dumps": {}}
    for key in ("off", "dumps"):
        outputs_train_run(torch, key, "syncs", syncs[key])
    if sorted(syncs["off"]) != sorted(syncs["dumps"]):
        fail(f"the sync-counted runs' steps differ: {sorted(syncs['off'])} "
             f"against {sorted(syncs['dumps'])}")
    quiet_syncs = {key: [syncs[key][g] for g in sorted(syncs[key])
                         if g in quiet] for key in syncs}
    runs["syncs"] = {
        "per_step_off": [syncs["off"][g] for g in sorted(syncs["off"])],
        "per_step_dumps": [syncs["dumps"][g] for g in sorted(syncs["dumps"])],
        "quiet_off": sum(quiet_syncs["off"]),
        "quiet_dumps": sum(quiet_syncs["dumps"])}
    if quiet_syncs["dumps"] != quiet_syncs["off"]:
        fail(f"with dumps the steps that neither dump nor follow a dump make "
             f"{quiet_syncs['dumps']} synchronizing calls, without "
             f"{quiet_syncs['off']}")
    if not sum(quiet_syncs["off"]):
        fail("set_sync_debug_mode('warn') counted no synchronizing call")
    print("outputs_train", json.dumps(runs))
    return runs, total


def outputs_profile_part(torch) -> tuple:
    """(d) of phase 11k: the evaluate CLI's ``profile_dir`` on the card:
    the trained flagship's host protocol on PROFILE_OBJECTS objects,
    PROFILE_CLICKS clicks, one forward a click, with the ``torch.profiler``
    trace of the evaluation written to the directory; the trace must hold
    CUDA kernel events, kernel B's among them. Returns (record,
    launches)."""
    from isegprobe_torch import evaluate as evaluate_cli
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset

    trace_dir = Path(scratch()) / "profile"
    cfg = evaluate_cli.parse_args([
        f"checkpoint={TRAINED_CKPTS['flagship']}", "datasets=Synthetic",
        "eval_mode=fixed448", f"n_clicks={PROFILE_CLICKS}",
        "print_ious=false", f"profile_dir={trace_dir}"])
    model, _ = eval_load(torch, cfg["checkpoint"], torch.float32)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.time()
    out = evaluate_cli.evaluate(cfg, model, dataset=SceneDataset(
        SYNTHETIC_FIXTURE, objects=slice(0, PROFILE_OBJECTS)))
    wall = time.time() - t0
    launches = counters()
    n_clicks = sum(len(a) for a in out["all_ious"])
    want = expected(**{k: v * n_clicks for k, v in
                       FORWARD_LAUNCHES["flagship"].items()})
    if out["protocol"] != "host" or launches != want:
        fail(f"the profiled evaluation ran {out['protocol']} and launched "
             f"{launches} for {n_clicks} clicks, expected {want}")
    path = trace_dir / f"{out['model_name']}_Synthetic.pt.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    rec = {"objects": PROFILE_OBJECTS, "clicks": n_clicks, "wall_s": wall,
           "trace_mb": path.stat().st_size / 2**20, "events": len(events),
           "kernel_events": len(kernels),
           "ln_kernel_events": sum("ln_kernel" in k for k in kernels),
           "attn_kernel_events": sum("attn_qkv" in k for k in kernels)}
    path.unlink()
    print("outputs_profile_dir", json.dumps(rec))
    if not rec["ln_kernel_events"]:
        fail(f"the profile_dir trace holds no kernel B events: {rec}")
    return rec, launches


def run_outputs_phase(torch) -> dict:
    """Main paths of a researcher's outputs (phase 11k of the module
    docstring): (a) the evaluate CLI with every output key; (b) the
    feature probe of the trained probes; (c) the train CLI's run logs,
    events and image dumps; (d) the evaluate CLI's ``profile_dir``.
    Returns the records and the path launches."""
    fx = dict(np.load(OUTPUTS_FIXTURE))
    res: dict = {}
    res["evaluate"], eval_launches = outputs_eval_part(torch, fx)
    res["feats"], feats_launches = outputs_feats_part(torch, fx)
    res["train"], train_launches = outputs_train_part(torch)
    res["profile_dir"], profile_launches = outputs_profile_part(torch)
    res["path_launches"] = {
        "outputs_evaluate_cli": eval_launches,
        "outputs_feature_probe": feats_launches,
        "outputs_profiled_evaluate": profile_launches,
        **{f"outputs_train_{key}_{kind}": counts
           for key, by_kind in train_launches.items()
           for kind, counts in by_kind.items()}}
    return res


# -- phase 11l: int8 W8A8 serving ------------------------------------------------

def quantize_case(torch, quant, shape, dtype: str, seed: int,
                  what: str) -> dict:
    """Kernel H against its plain version at one ``[R, K]`` shape, bit for
    bit (the int8 rows and the f32 scales), timed beside it. Rows are
    drawn with magnitudes spread over e^±3, as activations are; no PyTorch
    call computes this function (``library_ms`` None)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows, k = shape
    x = (torch.randn(shape, generator=g, device="cuda") * torch.exp(
        torch.rand((rows, 1), generator=g, device="cuda") * 6 - 3)
         ).to(getattr(torch, dtype))
    q, s = quant.quantize_rows(x)
    want_q, want_s = quant._quantize_rows_plain(x)
    torch.cuda.synchronize()
    err = max(float((q.int() - want_q.int()).abs().max()),
              float((s - want_s).abs().max()))
    res = {"max_abs_err": err, "ok": bool(torch.equal(q, want_q))
           and bool(torch.equal(s, want_s)), "library_ms": None}
    res["ms"], res["timing"] = time_ms(torch, lambda: quant.quantize_rows(x))
    res["plain_ms"], _ = time_ms(
        torch, lambda: quant._quantize_rows_plain(x))
    n = x.numel()
    # |x|, max, divide, round a value (f32, outside the tensor cores); x
    # read once, q written once, one scale a row
    res.update(_bound(4.0 * n, n * (x.element_size() + 1) + 4 * rows,
                      "float32"))
    res.update(kernel="quantize_rows", shape=list(shape), dtype=dtype,
               what=what)
    return res


def int8_gemm_case(torch, F, quant, m: int, k: int, n: int, dtype: str,
                   seed: int, what: str, bias_after_cast: bool = False
                   ) -> dict:
    """Kernel I against its plain version at ``[m, k] x [n, k]``, bit for
    bit, on operands that kernel H quantized from drawn bf16 activations
    and weights, writing ``dtype`` with a bias of that dtype, timed beside
    the plain version and two yardsticks the port never calls:
    ``torch._int_mm`` with the plain epilogue (``library_ms``) and bf16
    ``F.linear`` of the same product (``linear_bf16_ms``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out_dtype = getattr(torch, dtype)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn((n, k), generator=g, device="cuda") / k**0.5).to(
        torch.bfloat16)
    bias = torch.randn(n, generator=g, device="cuda").to(out_dtype)
    xq, sx = quant.quantize_rows(x)
    wq, sw = quant.quantize_rows(w)
    sw = sw.reshape(-1)

    def kernel():
        return quant.int8_gemm(xq, wq, sx, sw, bias, out_dtype,
                               bias_after_cast)

    def plain():
        return quant._int8_gemm_plain(xq, wq, sx, sw, bias, out_dtype,
                                      bias_after_cast)

    def int_mm():
        acc = torch._int_mm(xq, wq.t())
        return quant._epilogue_plain(acc.float(), sx, sw, bias, out_dtype,
                                     bias_after_cast)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    res = {"max_abs_err": float((got.float() - want.float()).abs().max()),
           "ok": bool(torch.equal(got, want))}
    res["ms"], res["timing"] = time_ms(torch, kernel)
    res["plain_ms"], _ = time_ms(torch, plain)
    try:
        lib = int_mm()
        res["library_equal"] = bool(torch.equal(lib, want))
        res["library_ms"], _ = time_ms(torch, int_mm)
    except RuntimeError as e:  # a yardstick only
        res["library_ms"], res["library_error"] = None, str(e)[:200]
    wb, bb = w, bias.to(torch.bfloat16)
    res["linear_bf16_ms"], _ = time_ms(torch, lambda: F.linear(x, wb, bb))
    ops = 2.0 * m * n * k
    nbytes = (m * k + n * k + 4 * (m + n) + n * bias.element_size()
              + m * n * got.element_size())
    res.update(_bound(ops, nbytes, "int8"))
    res["linear_bf16_bound_ms"] = _bound(
        ops, 2 * (m * k + n * k + n + m * n), "bfloat16")["bound_ms"]
    res.update(kernel="int8_gemm", shape=[m, k, n], dtype=dtype, what=what,
               bias_after_cast=bias_after_cast)
    return res


def int8_ragged(torch, quant) -> dict:
    """Kernel I bit for bit against its plain version at every INT8_RAGGED
    shape (ragged tiles and K-blocks: the loads zero-filled, the stores
    clipped), writing f32 and bf16, with no bias and the bias before and
    after the cast, on drawn int8 operands and scales."""
    cases, bad = 0, []
    for m in INT8_RAGGED[0]:
        for n in INT8_RAGGED[1]:
            for k in INT8_RAGGED[2]:
                g = torch.Generator(device="cuda").manual_seed(
                    m * 7 + n * 3 + k)
                xq, wq = (torch.randint(-127, 128, shape, generator=g,
                                        device="cuda", dtype=torch.int8)
                          for shape in ((m, k), (n, k)))
                sx = torch.rand(m, generator=g, device="cuda") + 0.01
                sw = torch.rand(n, generator=g, device="cuda") * 0.01
                b = torch.randn(n, generator=g, device="cuda")
                for dtype in (torch.float32, torch.bfloat16):
                    for bias, after in ((None, False), (b.to(dtype), False),
                                        (b.to(dtype), True)):
                        got = quant.int8_gemm(xq, wq, sx, sw, bias, dtype,
                                              after)
                        want = quant._int8_gemm_plain(xq, wq, sx, sw, bias,
                                                      dtype, after)
                        cases += 1
                        if not bool(torch.equal(got, want)):
                            bad.append({"shape": [m, k, n],
                                        "dtype": str(dtype),
                                        "bias": bias is not None,
                                        "after": after})
    torch.cuda.synchronize()
    return {"cases": cases, "bad": bad}


def noc_gap(a, b) -> float:
    return max(abs(float(x) - float(y)) for x, y in zip(a, b))


def int8_host_clicks(torch, model, fx, per_forward: dict,
                     what: str) -> dict:
    """The host protocol (``Predictor``, fixed-448 ZoomIn, flip, the
    trained protocol) on the int8 fixture's first INT8_HOST_OBJECTS
    objects: exactly one forward's launches a click, p50 ms per click and
    per ``get_prediction``, and the IoUs beside JAX's int8 device loop's
    (a report: int8 rounds the card's bf16 noise into whole quanta, so no
    per-IoU gate)."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference.evaluation import (
        evaluate_sample,
        latency_percentiles,
    )
    from isegprobe_torch.inference.predictor import Predictor

    m = INT8_HOST_OBJECTS
    predictor = Predictor(model, target_size=(448, 448), with_flip=True,
                          net_clicks_limit=TRAINED_CLICKS)
    data = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, m))
    samples = [data.get_sample(i) for i in range(m)]
    evaluate_sample(samples[0].image, samples[0].gt_mask(0), predictor,
                    max_iou_thr=2.0, max_clicks=1)  # warm-up
    click_s = time_clicks(predictor)
    per_click, ious = [], []
    zero_counters()
    for sample in samples:
        t0 = time.time()
        _, got, _ = evaluate_sample(
            sample.image, sample.gt_mask(0), predictor,
            max_iou_thr=TRAINED_TARGET, pred_thr=TRAINED_THRESH,
            max_clicks=TRAINED_CLICKS)
        per_click.append((time.time() - t0) / len(got))
        ious.append([float(v) for v in got])
    launches = counters()
    n_clicks = sum(len(a) for a in ious)
    if launches != expected(**{k: v * n_clicks
                               for k, v in per_forward.items()}):
        fail(f"{what} host protocol launched {launches} for {n_clicks} "
             "clicks")
    rec = {"objects": m, "clicks": n_clicks, "launches": launches,
           "per_get_prediction": latency_percentiles(click_s),
           "per_click_protocol": latency_percentiles(per_click),
           "ious": ious,
           "jax_int8_loop_ious": [[float(v) for v in fx["int8_ious"][i, :int(
               fx["int8_n"][i])]] for i in range(m)]}
    print(f"{what} host", json.dumps(rec))
    return rec


def int8_phase(torch, F) -> dict:
    """int8 W8A8 serving (phase 11l of the module docstring): kernels H
    and I bit for bit against their plain versions at the paths' shapes,
    timed beside their bounds and yardsticks; the trained flagship loaded
    with ``dtype="int8"`` (one host forward against JAX's int8 logits and
    the port's bf16 forward, ms a forward; the device loop at B=8 on the 78
    objects against JAX's int8 NoC on the fixture's; one host click); the
    trained MaskCLIP in int8 against its CPU plain path; the drawn DINO key
    probe in int8; the trained 448² LoftUp in int8 (padded) through a loop.
    Every path's launches are exact. Returns the records, the path launches
    and the kernel checks."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.models.probe_model import (
        iSegProbeModel,
        synthetic_config,
    )
    from isegprobe_torch.models.vit import init_params
    from isegprobe_torch.ops import quant

    res: dict = {}
    paths: dict = {}
    fwd, host = 2 * TRAINED_BATCH * 1025, 2 * 1025
    clip_rows = 2 * 785
    checks, seed = [], 400
    for shape, dtype in [((r, d), dt) for dt in ("bfloat16", "float32")
                         for r, d in ((fwd, 384), (fwd, 1536),
                                      (host, 384))] + [
            ((1152, 384), "bfloat16"), ((1536, 384), "bfloat16"),
            ((384, 1536), "bfloat16")]:
        checks.append(quantize_case(torch, quant, shape, dtype, seed,
                                    "weight" if shape[0] < host
                                    else "activations"))
        seed += 1
    products = ((384, 1152), (384, 384), (384, 1536), (1536, 384))
    for m in (fwd, host):
        for k, n in products:
            checks.append(int8_gemm_case(torch, F, quant, m, k, n,
                                         "bfloat16", seed, "flagship"))
            seed += 1
    for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
        checks.append(int8_gemm_case(
            torch, F, quant, clip_rows, k, n, "bfloat16", seed, "maskclip",
            bias_after_cast=(k, n) == (768, 2304)))
        seed += 1
    checks.append(int8_gemm_case(torch, F, quant, host, 384, 1152,
                                 "float32", seed, "float32 output"))
    res["ragged"] = int8_ragged(torch, quant)
    print("int8 ragged I", json.dumps(res["ragged"]))
    if res["ragged"]["bad"]:
        fail(f"kernel I differs from its plain version at ragged shapes: "
             f"{res['ragged']['bad']}")
    for c in checks:
        print(f"int8 check {c['kernel']} {c['shape']} {c['dtype']}: "
              f"bitwise {c['ok']}, {c['ms']:.4f} ms (bound "
              f"{c['bound_ms']:.4f}, {c['bound_by']}; plain "
              f"{c['plain_ms']:.4f}; library {c['library_ms']}"
              + (f"; bf16 F.linear {c['linear_bf16_ms']:.4f}"
                 if "linear_bf16_ms" in c else "") + ")")

    fx = dict(np.load(INT8_FIXTURE))
    scenes = dict(np.load(SYNTHETIC_FIXTURE))
    data = SceneDataset(SYNTHETIC_FIXTURE)
    k_fx = int(fx["int8_objects"])
    per_forward = INT8_LAUNCHES["flagship"]
    models = {}
    for name, dtype in (("int8", "int8"), ("bfloat16", torch.bfloat16)):
        t0 = time.time()
        models[name], _ = eval_load(torch, TRAINED_CKPTS["flagship"], dtype)
        res[f"load_{name}_s"] = time.time() - t0
    model = models["int8"]

    # one host forward at 448², batch 2, against JAX's int8 logits and the
    # port's bf16 forward
    img = fx["logits_image"].astype(np.float32) / 255.0
    image = np.zeros((2, 448, 448, 4), np.float32)
    image[0, ..., :3], image[1, ..., :3] = img, img[:, ::-1]
    img_d = torch.from_numpy(image).cuda()
    pts_d = torch.from_numpy(fx["logits_points"].astype(np.float32)).cuda()
    with torch.inference_mode():
        zero_counters()
        logits = model(img_d, pts_d)["instances"]
        torch.cuda.synchronize()
        got_first = {k: v for k, v in counters().items() if v}
        zero_counters()
        logits_again = model(img_d, pts_d)["instances"]
        torch.cuda.synchronize()
        got = {k: v for k, v in counters().items() if v}
        logits16 = models["bfloat16"](img_d, pts_d)["instances"]
        ms = {}
        for name, b in (("batch2", 2), ("batch16", 2 * TRAINED_BATCH)):
            reps = -(-b // 2)
            img_b, pts_b = img_d.repeat(reps, 1, 1, 1), pts_d.repeat(reps, 1,
                                                                     1)
            for dt in ("bfloat16", "int8", "int8", "bfloat16"):
                ms.setdefault(f"{dt}_{name}", []).append(time_ms(
                    torch, lambda m=models[dt]: m(img_b, pts_b), reps=5,
                    rounds=3, graph=False)[0])
    want = fx["logits"]
    out = logits.float().cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(out - want).max())
    p8 = 1 / (1 + np.exp(-out))
    p16 = 1 / (1 + np.exp(-logits16.float().cpu().numpy()))
    prob_err = float(np.abs(p8 - p16).max())
    res["forward"] = {"launches_per_forward": got,
                      "launches_first_forward": got_first,
                      "cached_equals_first": bool(torch.equal(
                          logits, logits_again)),
                      "max_abs_err_vs_jax_int8": err, "logit_scale": scale,
                      "err_share_of_scale": err / scale,
                      "max_prob_err_vs_bf16": prob_err,
                      "forward_ms": {k: min(v) for k, v in ms.items()},
                      "forward_ms_all": ms}
    print("int8 forward", json.dumps(res["forward"]))
    if not np.isfinite(out).all() or out.shape != want.shape:
        fail(f"int8 forward: bad logits {out.shape}")
    if err > INT8_LOGIT_TOL * scale:
        fail(f"int8 forward differs from JAX's int8 logits by {err} > "
             f"2^-6 of their scale {scale}")
    if prob_err > INT8_PROB_TOL:
        fail(f"int8 probabilities differ from bf16's by {prob_err} > "
             f"{INT8_PROB_TOL}")
    if got != per_forward or got_first != int8_first_forward(per_forward):
        fail(f"int8 forward launched {got_first}, then {got}; expected "
             f"{int8_first_forward(per_forward)}, then {per_forward}")
    if not res["forward"]["cached_equals_first"]:
        fail("int8 forward on cached weight rows differs from the first")
    paths["int8_forward"] = expected(**per_forward)

    # the device loops at B=8 on the 78 objects: bf16 beside int8; int8's
    # NoC on the fixture's objects against JAX's int8 NoC
    def evaluator(m, batch, max_clicks=TRAINED_CLICKS):
        return device_eval.make_device_evaluator(
            m, target_size=(448, 448), batch_size=batch,
            max_clicks=max_clicks, net_clicks_limit=max_clicks,
            pred_thr=TRAINED_THRESH, target_iou=TRAINED_TARGET,
            record_clicks=True)

    def noc_of(all_ious, max_clicks=TRAINED_CLICKS):
        return [float(v) for v in compute_noc_metric(
            all_ious, [0.8, 0.85, 0.9], max_clicks)[0]]

    loops = {}
    for name in ("bfloat16", "int8"):
        m = models[name]
        device_eval.evaluate_dataset_device(evaluator(m, TRAINED_BATCH, 1),
                                            data)  # warm-up
        run = evaluator(m, TRAINED_BATCH)
        clicks: list = []
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.time()
        got = device_eval.evaluate_dataset_device(run, data, clicks=clicks)
        wall = time.time() - t0
        launches = counters()
        per_step = dict(edt_row_envelope=1,
                        **(per_forward if name == "int8"
                           else FORWARD_LAUNCHES["flagship"]))
        want_l = expected(**{k: v * run.steps for k, v in per_step.items()})
        if launches != want_l:
            fail(f"{name} B=8 loop launched {launches} in {run.steps} "
                 f"steps, expected {want_l}")
        n_clicks = sum(len(a) for a in got)
        rec = {"batch": TRAINED_BATCH, "objects": len(got),
               "steps": run.steps, "clicks": n_clicks, "wall_s": wall,
               "ms_per_step": 1e3 * wall / run.steps,
               "lane_clicks_per_s": n_clicks / wall, "noc": noc_of(got),
               "jax_f32_noc": [float(v) for v in scenes["flagship_noc"]]}
        rec["noc_gap_to_jax_f32"] = noc_gap(rec["noc"], rec["jax_f32_noc"])
        if name == "int8":
            rec["launches"] = launches
            rec["fixture_objects"] = k_fx
            rec["noc_on_fixture"] = noc_of(got[:k_fx])
            rec["jax_int8_noc"] = [float(v) for v in fx["int8_noc"]]
            rec["noc_gap_to_jax_int8"] = noc_gap(rec["noc_on_fixture"],
                                                 rec["jax_int8_noc"])
            parted = []
            for i in range(k_fx):
                n = int(fx["int8_n"][i])
                mine = [tuple(int(v) for v in c) for c in clicks[i]]
                theirs = [tuple(int(v) for v in c)
                          for c in fx["int8_clicks"][i, :n]]
                if mine != theirs:
                    j = next((j for j, (a, b) in enumerate(zip(mine, theirs))
                              if a != b), min(len(mine), n))
                    parted.append({"object": i, "click": j + 1})
            rec["objects_parting_from_jax_int8"] = parted
            paths["int8_device_loop"] = launches
        loops[name] = rec
        print(f"{name} B=8 device loop", json.dumps(rec))
    res["device_loops"] = loops
    if loops["int8"]["noc_gap_to_jax_int8"] > INT8_NOC_TOL:
        fail(f"int8 NoC@80/85/90 {loops['int8']['noc_on_fixture']} on the "
             f"fixture's {k_fx} objects differ from JAX's int8 "
             f"{loops['int8']['jax_int8_noc']} by more than {INT8_NOC_TOL}")

    # host clicks in bf16, then int8: the host protocol on the fixture's
    # first objects, exact launches a click, p50 ms beside JAX's int8 IoUs
    res["host_bf16"] = int8_host_clicks(
        torch, models["bfloat16"], fx, FORWARD_LAUNCHES["flagship"], "bf16")
    res["host"] = int8_host_clicks(torch, model, fx, per_forward, "int8")
    paths["int8_host"] = res["host"]["launches"]
    del models

    # the trained MaskCLIP in int8: a 224² batch-2 forward on the card
    # against the CPU plain path
    clip_fwd = INT8_LAUNCHES["maskclip_noup"]
    clip, _ = eval_load(torch, TRAINED_CKPTS["maskclip"], "int8")
    clip_cpu, _ = eval_load(torch, TRAINED_CKPTS["maskclip"], "int8",
                            device="cpu")
    rng = np.random.default_rng(7)
    size = INT8_CLIP_SIZE
    image = rng.random((2, size, size, 4), dtype=np.float32)
    points = np.full((2, 4, 3), -1.0, np.float32)
    points[:, 0] = (size * 0.4, size * 0.5, 0)
    points[1, 2] = (size * 0.8, size * 0.2, 1)
    with torch.inference_mode():
        launched = []
        for _ in range(2):  # the weights' rows quantized, then cached
            zero_counters()
            got_l = clip(torch.from_numpy(image).cuda(),
                         torch.from_numpy(points).cuda())["instances"]
            torch.cuda.synchronize()
            launched.append({k: v for k, v in counters().items() if v})
        got_first, got = launched
        ref = clip_cpu(torch.from_numpy(image),
                       torch.from_numpy(points))["instances"]
    err = float((got_l.float().cpu() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    res["maskclip"] = {"size": size, "launches_per_forward": got,
                       "launches_first_forward": got_first,
                       "max_abs_err_vs_cpu": err, "logit_scale": scale}
    print("int8 MaskCLIP forward", json.dumps(res["maskclip"]))
    if err > INT8_MASKCLIP_TOL * scale or not bool(
            torch.isfinite(got_l).all()):
        fail(f"int8 MaskCLIP: card forward differs from the CPU plain path "
             f"by {err} (logit scale {scale})")
    if got != clip_fwd or got_first != int8_first_forward(clip_fwd):
        fail(f"int8 MaskCLIP launched {got_first}, then {got}; expected "
             f"{int8_first_forward(clip_fwd)}, then {clip_fwd}")
    paths["int8_maskclip_forward"] = expected(**clip_fwd)
    del clip, clip_cpu

    # the drawn DINO key probe in int8 (bf16 params, as the CLI casts them)
    key_fwd = INT8_LAUNCHES["vit_noup"]
    cfg = synthetic_config("vit_noup", (448, 448))
    key = init_params(iSegProbeModel(**cfg, quant="int8"), seed=0).eval()
    key.to(torch.bfloat16)
    with torch.inference_mode():
        launched = []
        for _ in range(2):  # the weights' rows quantized, then cached
            zero_counters()
            kl = key(img_d, pts_d)["instances"]
            torch.cuda.synchronize()
            launched.append({k: v for k, v in counters().items() if v})
        got_first, got = launched
    res["dino_key"] = {"launches_per_forward": got,
                       "launches_first_forward": got_first,
                       "finite": bool(torch.isfinite(kl).all()),
                       "shape": list(kl.shape)}
    print("int8 DINO key probe forward", json.dumps(res["dino_key"]))
    if (got != key_fwd or got_first != int8_first_forward(key_fwd)
            or not res["dino_key"]["finite"]):
        fail(f"int8 DINO key probe: launched {got_first}, then {got} "
             f"(expected {int8_first_forward(key_fwd)}, then {key_fwd}), "
             f"finite {res['dino_key']['finite']}")
    paths["int8_dino_key_forward"] = expected(**key_fwd)
    del key

    # the trained 448² LoftUp in int8: the padded layout (D at dh 128), a
    # loop of the fixture's LoftUp objects and clicks, beside JAX's f32
    loft, info = eval_load(torch, TRAINED_CKPTS["loftup"], "int8")
    if not info["config"]["params"]["upsampler_cfg"]["params"].get(
            "mxu_pad"):
        fail("int8 LoftUp: not in the padded layout")
    run = evaluator(loft, TRAINED_LOFTUP_OBJECTS, TRAINED_LOFTUP_CLICKS)
    loft_data = SceneDataset(SYNTHETIC_FIXTURE,
                             objects=slice(0, TRAINED_LOFTUP_OBJECTS))
    clicks = []
    zero_counters()
    t0 = time.time()
    got = device_eval.evaluate_dataset_device(run, loft_data, clicks=clicks)
    wall = time.time() - t0
    launches = counters()
    per_step = dict(edt_row_envelope=1, **INT8_LAUNCHES["loftup"])
    want_l = expected(**{k: v * run.steps for k, v in per_step.items()})
    want_l["quantize_rows"] += INT8_LAUNCHES["loftup"]["int8_gemm"]
    if launches != want_l:
        fail(f"int8 LoftUp loop launched {launches} in {run.steps} steps "
             f"(its first quantizes the weights), expected {want_l}")
    res["loftup"] = {
        "objects": TRAINED_LOFTUP_OBJECTS, "clicks": TRAINED_LOFTUP_CLICKS,
        "steps": run.steps, "wall_s": wall,
        "ms_per_step": 1e3 * wall / run.steps,
        "ious": [[float(v) for v in a] for a in got],
        "jax_f32_ious": [[float(v) for v in fx_i[:int(n)]] for fx_i, n in
                         zip(scenes["loftup_ious"], scenes["loftup_n"])],
        "same_clicks_as_jax_f32": [
            [tuple(int(v) for v in c) for c in clicks[i]]
            == [tuple(int(v) for v in c)
                for c in scenes["loftup_clicks"][i, :int(
                    scenes["loftup_n"][i])]]
            for i in range(TRAINED_LOFTUP_OBJECTS)]}
    print("int8 LoftUp loop", json.dumps(res["loftup"]))
    if not all(np.isfinite(a).all() and len(a) for a in got):
        fail(f"int8 LoftUp loop: bad trajectories {got}")
    paths["int8_loftup_loop"] = launches
    del loft
    res["path_launches"] = paths
    res["checks"] = checks
    return res


# -- phase 11m: the demo and parallel/ -------------------------------------

# the gloo ranks' and the NCCL group of one's steps: the flagship at 224²,
# batch 8 (4 a rank on two ranks), two simulated clicks
PAR_ITERS = 2
PAR_ARGV = ["model=synthetic_dinov2_noup", "dataloader.workers=0",
            "training.seed=0"]
# a data-parallel step against one rank's (tests/test_torch_parallel.py):
# loss within 1e-6, each trainable leaf within 1e-5 of its L2 norm
PAR_LOSS_ATOL = 1e-6
PAR_LEAF_RTOL = 1e-5
# the TP forward against the replicated one, of the logit scale (JAX's
# tests/test_tensor_parallel.py: rtol = atol = 1e-5)
PAR_TP_RTOL = 1e-5
PAR_SPAWN_TIMEOUT = 240
DEMO_OBJECTS = 2


def _parallel_rank(rank, world, store, out_dir):
    """One of two gloo ranks on the one card (phase 11m (b)): a
    data-parallel step (2 × 1, 4 rows a rank) and the tensor-parallel
    forward (1 × 2, 3 heads a rank) of the flagship, from the parent's
    initial tree; results and launch counts to ``out_dir/rank<k>.pt``."""
    import torch
    import torch.distributed as dist

    from isegprobe_torch import train as train_cli
    from isegprobe_torch.parallel import tp
    from isegprobe_torch.parallel.mesh import make_mesh, put_global_batch

    out_dir = Path(out_dir)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out: dict = {}
    try:
        params = torch.load(out_dir / "tree.pt", weights_only=False)
        gb = dict(np.load(out_dir / "batch.npz"))
        argv = [*PAR_ARGV, f"exp_path={out_dir / 'runs'}"]
        mesh = make_mesh(device="cuda:0")
        trainer = train_cli.build_trainer(train_cli.parse_args(argv),
                                          params=params, mesh=mesh)
        rows = put_global_batch(gb, mesh, multiprocess=False)
        torch.cuda.synchronize()
        zero_counters()
        loss = float(trainer._step(rows, PAR_ITERS)[0])
        torch.cuda.synchronize()
        out["dp"] = {"loss": loss, "launches": counters(),
                     "rows": int(rows["images"].shape[0]),
                     "leaves": {n: p.detach().cpu() for n, p in
                                trainer.model.named_parameters()
                                if p.requires_grad}}
        trainer.shutdown()
        del trainer
        mesh = make_mesh(model_parallel=2, device="cuda:0")
        trainer = train_cli.build_trainer(train_cli.parse_args(argv),
                                          params=params, mesh=mesh)
        attn = [m for m in trainer.model.modules()
                if isinstance(m, tp.TPAttention)]
        batch = trainer._upload(gb)
        with torch.no_grad():
            images = batch["images"].float() / 255.0
            net = torch.cat([images, torch.zeros_like(images[..., :1])], -1)
            torch.cuda.synchronize()
            zero_counters()
            logits = trainer.model(net, batch["points"])["instances"]
            torch.cuda.synchronize()
        out["tp"] = {"logits": logits.cpu(), "launches": counters(),
                     "heads": [m.num_heads for m in attn],
                     "qkv_width": int(attn[0].qkv.weight.shape[0])}
        trainer.shutdown()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, out_dir / f"rank{rank}.pt")


def _start_ranks(torch, world: int, out_dir: Path):
    import torch.multiprocessing as mp

    return mp.start_processes(_parallel_rank,
                              args=(world, str(out_dir / "store"),
                                    str(out_dir)),
                              nprocs=world, join=False,
                              start_method="spawn")


def _join_ranks(ctx) -> float:
    t0 = time.time()
    deadline = t0 + PAR_SPAWN_TIMEOUT
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                fail(f"the gloo ranks did not finish in {PAR_SPAWN_TIMEOUT} "
                     "s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return time.time() - t0


def _leaf_errors(got: dict, want: dict) -> float:
    """The largest L2 norm of a leaf's difference over the leaf's."""
    if got.keys() != want.keys():
        fail(f"the leaves differ: {sorted(got)} != {sorted(want)}")
    return max(float((got[k] - want[k]).norm() / want[k].norm().clamp_min(
        1e-30)) for k in want)


def demo_part(torch, model, fx, per_forward: dict) -> tuple:
    """(a) of phase 11m: the demo's predictor builder and controller,
    headless, on the trained flagship at the fixture's first objects'
    clicks (JAX's), beside the port's host ``Predictor`` at the same clicks:
    every map bitwise, undo bitwise, the committed mask, a mask PNG round
    trip, launches and p50 ms a click. Returns (record, launches of the
    controller's clicks)."""
    from isegprobe_torch.data.image_io import read_bgr, write_png
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.demo import make_predictor_builder, parse_args
    from isegprobe_torch.inference.clicker import Click, Clicker
    from isegprobe_torch.inference.evaluation import latency_percentiles
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.interactive_demo.controller import (
        InteractiveController,
    )

    cfg = parse_args([f"checkpoint={TRAINED_CKPTS['flagship']}",
                      "eval_mode=fixed448"])
    builder = make_predictor_builder(cfg, model=model)
    ctrl = InteractiveController(lambda: builder(),
                                 prob_thresh=TRAINED_THRESH)
    data = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, DEMO_OBJECTS))
    ctrl_ms, host_ms, n_clicks = [], [], 0
    zero_counters()
    ctrl_launches = counters()
    for i in range(DEMO_OBJECTS):
        sample = data.get_sample(i)
        n = int(fx["flagship_n"][i])
        clicks = [tuple(int(v) for v in c)
                  for c in fx["flagship_clicks"][i, :n]]
        host = Predictor(model, target_size=(448, 448), with_flip=True,
                         net_clicks_limit=TRAINED_CLICKS)
        host.set_input_image(sample.image)
        clicker = Clicker()
        ctrl.set_image(sample.image)
        maps = []
        for y, x, pos in clicks:
            clicker.add_click(Click(is_positive=bool(pos), coords=(y, x)))
            zero_counters()
            t = time.perf_counter()
            want = host.get_prediction(clicker)
            host_ms.append(1e3 * (time.perf_counter() - t))
            got_h = counters()
            zero_counters()
            t = time.perf_counter()
            ctrl.add_click(x, y, bool(pos))
            ctrl_ms.append(1e3 * (time.perf_counter() - t))
            got_c = counters()
            if got_c != got_h or got_h != expected(**per_forward):
                fail(f"demo object {i}: a controller click launched "
                     f"{got_c}, a host click {got_h}, one forward "
                     f"{per_forward}")
            for k in KERNELS:
                ctrl_launches[k] += got_c[k]
            n_clicks += 1
            prob = ctrl.current_object_prob
            if not np.array_equal(prob, want):
                fail(f"demo object {i} click {len(maps) + 1}: the "
                     "controller's map differs from the host Predictor's "
                     f"by {float(np.abs(prob - want).max())}")
            maps.append(prob)
        if n > 1:
            ctrl.undo_click()
            if not np.array_equal(ctrl.current_object_prob, maps[-2]):
                fail(f"demo object {i}: undo does not restore the previous "
                     "map")
            y, x, pos = clicks[-1]
            ctrl.add_click(x, y, bool(pos))
            if not np.array_equal(ctrl.current_object_prob, maps[-1]):
                fail(f"demo object {i}: the click after undo differs")
        ctrl.finish_object()
        labels = ctrl.result_mask
        if ctrl.object_count != 1 or not np.array_equal(
                labels, (maps[-1] > TRAINED_THRESH).astype(np.uint16)):
            fail(f"demo object {i}: result_mask is not the finished draft")
        path = Path(scratch()) / f"demo_mask_{i}.png"
        write_png(path, labels.astype(np.uint8) * 255)
        back = read_bgr(path)[:, :, 0] > 127
        if not np.array_equal(back, labels > 0) or not ctrl.set_mask(back):
            fail(f"demo object {i}: the mask PNG does not round-trip")
        ctrl.reset_last_object()
    rec = {"objects": DEMO_OBJECTS, "clicks": n_clicks,
           "controller_click_ms": latency_percentiles(
               [v / 1e3 for v in ctrl_ms]),
           "host_click_ms": latency_percentiles([v / 1e3 for v in host_ms]),
           "controller_click_p50_ms": float(np.median(ctrl_ms)),
           "host_click_p50_ms": float(np.median(host_ms)),
           "launches_per_click": expected(**per_forward)}
    print("demo", json.dumps(rec))
    print(f"demo: {n_clicks} controller clicks bitwise the host Predictor's, "
          f"p50 {rec['controller_click_p50_ms']:.2f} ms a controller click, "
          f"{rec['host_click_p50_ms']:.2f} ms a host click")
    return rec, ctrl_launches


def evaluators_part(torch, model, fx) -> tuple:
    """(c) of phase 11m: the mesh evaluator (16 lanes, 8 a device) and one
    job queue a device (8 lanes) on ``[cuda:0, cuda:0]`` over the 78
    objects against the one-device lockstep loop at 8 lanes, lane for lane
    (a device's lanes see the shapes of the one-device run), NoC against
    the fixture's; the evaluate CLI with ``device_mesh=true`` (one visible
    GPU: one warning, then the one-device run), lockstep and with
    ``device_refill``, against the same command without it on the first
    16 objects."""
    import logging

    from isegprobe_torch import evaluate as cli
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.metrics import compute_noc_metric

    data = SceneDataset(SYNTHETIC_FIXTURE)
    devices = [torch.device("cuda", 0)] * 2
    kw = dict(target_size=(448, 448), max_clicks=TRAINED_CLICKS,
              net_clicks_limit=TRAINED_CLICKS, pred_thr=TRAINED_THRESH,
              target_iou=TRAINED_TARGET, record_clicks=True)
    rec, launches, runs = {}, {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.time()
        clicks: list = []
        ious = fn(clicks)
        torch.cuda.synchronize()
        launches[name] = counters()
        runs[name] = (ious, clicks)
        noc = [float(v) for v in compute_noc_metric(
            ious, [0.8, 0.85, 0.9], TRAINED_CLICKS)[0]]
        rec[name] = {"s": time.time() - t0, "noc": noc,
                     "clicks": sum(len(a) for a in ious)}
        return ious, clicks

    one = device_eval.make_device_evaluator(model, batch_size=TRAINED_BATCH,
                                            **kw)
    timed("lockstep_one_device", lambda c: device_eval.evaluate_dataset_device(
        one, data, clicks=c))
    mesh = device_eval.make_device_evaluator(
        model, batch_size=2 * TRAINED_BATCH, mesh=devices, **kw)
    timed("mesh_evaluator", lambda c: device_eval.evaluate_dataset_device(
        mesh, data, clicks=c))
    group = device_eval.make_device_evaluator(
        model, batch_size=TRAINED_BATCH, group_api=True, **kw)
    stats: dict = {}
    timed("queue_per_device", lambda c: device_eval.evaluate_dataset_group(
        group, data, devices=devices, stats=stats, clicks=c))
    rec["queue_per_device"]["jobs_by_device"] = stats["jobs_by_device"]
    want_ious, want_clicks = runs["lockstep_one_device"]
    for name in ("mesh_evaluator", "queue_per_device"):
        ious, clicks = runs[name]
        same = all(np.array_equal(a, b) for a, b in zip(ious, want_ious)) \
            and all(np.array_equal(a, b) for a, b in zip(clicks, want_clicks))
        if not same or len(ious) != len(want_ious):
            fail(f"{name} on [cuda:0, cuda:0]: trajectories differ from the "
                 "one-device lockstep loop's")
        if rec[name]["noc"] != rec["lockstep_one_device"]["noc"]:
            fail(f"{name}: NoC {rec[name]['noc']} != the one-device run's")
    want_noc = [float(v) for v in fx["flagship_noc"]]
    gap = max(abs(a - b) for a, b in zip(rec["lockstep_one_device"]["noc"],
                                         want_noc))
    if gap > TRAINED_NOC_TOL:
        fail(f"the one-device loop's NoC {rec['lockstep_one_device']['noc']}"
             f" is {gap} from the fixture's {want_noc}")
    rec["fixture_noc"] = want_noc

    # the evaluate CLI's device_mesh on one visible GPU
    first = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, 16))
    base = [f"checkpoint={TRAINED_CKPTS['flagship']}", "eval_mode=fixed448",
            "device_loop=true", f"device_batch={TRAINED_BATCH}",
            "print_ious=false", f"thresh={TRAINED_THRESH}"]
    log = logging.getLogger(cli.__name__)
    cli_rec = {}
    for refill in ([], ["device_refill=true"]):
        key = "refill" if refill else "lockstep"
        out = {}
        for mesh_arg in ([], ["device_mesh=true"]):
            records: list = []
            handler = logging.Handler()
            handler.emit = records.append
            log.addHandler(handler)
            try:
                zero_counters()
                res = cli.evaluate(cli.parse_args([*base, *refill,
                                                   *mesh_arg]),
                                   model, "Synthetic", dataset=first)
                torch.cuda.synchronize()
            finally:
                log.removeHandler(handler)
            warned = [r.getMessage() for r in records
                      if "device_mesh" in r.getMessage()]
            out[bool(mesh_arg)] = (res, warned, counters())
        (plain, w0, _), (meshed, w1, got) = out[False], out[True]
        if w0 or len(w1) != 1:
            fail(f"evaluate CLI {key}: device_mesh warned {w1} (and "
                 f"without it {w0}); expected one warning")
        if not all(np.array_equal(a, b) for a, b in
                   zip(meshed["all_ious"], plain["all_ious"])):
            fail(f"evaluate CLI {key}: device_mesh=true differs from the "
                 "run without it")
        launches[f"evaluate_cli_device_mesh_{key}"] = got
        cli_rec[key] = {"warning": w1[0], "noc": [float(v) for v in
                                                   meshed["noc"]],
                        "protocol": meshed["protocol"]}
    rec["evaluate_cli"] = cli_rec
    print("evaluators", json.dumps(rec))
    return rec, launches


def demo_parallel_phase(torch) -> dict:
    """Main paths of the interactive demo and ``parallel/`` (phase 11m of
    the module docstring): (b) two gloo ranks on the one card, started
    first and joined after the NCCL group of one's check, (a) the demo and
    (c) the multi-device evaluators. Returns the records and the path
    launches."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE

    t_phase = time.time()
    res: dict = {}
    paths: dict = {}
    per_forward = FORWARD_LAUNCHES["flagship"]
    per_step = expected(**{k: v * (1 + PAR_ITERS)
                           for k, v in per_forward.items()},
                        edt_row_envelope=PAR_ITERS)

    # (b) the parallel paths: the two gloo ranks run while the parent
    # checks the plain step and the NCCL group of one
    out_dir = Path(scratch()) / "parallel"
    out_dir.mkdir(parents=True, exist_ok=True)
    argv = [*PAR_ARGV, f"exp_path={out_dir / 'runs_parent'}"]
    tree = initial_tree(argv)
    torch.save(tree, out_dir / "tree.pt")
    gb = drawn_batch(TRAIN_CROP, TRAIN_BATCH, seed=110)
    np.savez(out_dir / "batch.npz", **gb)
    ranks = _start_ranks(torch, 2, out_dir)
    try:
        plain_loss, plain_leaves, replicated = _parent_steps(
            torch, argv, gb, per_step, paths, res)
    finally:
        wait_s = _join_ranks(ranks)
    got = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    dp, tp_rec = [], []
    scale = float(replicated.abs().max())
    for r, g in enumerate(got):
        loss_err = abs(g["dp"]["loss"] - plain_loss)
        leaf_err = _leaf_errors(g["dp"]["leaves"], plain_leaves)
        if g["dp"]["launches"] != per_step or g["dp"]["rows"] != 4:
            fail(f"gloo rank {r}: the DP step launched "
                 f"{g['dp']['launches']} on {g['dp']['rows']} rows")
        if loss_err > PAR_LOSS_ATOL or leaf_err > PAR_LEAF_RTOL:
            fail(f"gloo rank {r}: the DP step's loss is {loss_err} and a "
                 f"leaf {leaf_err} of its norm from one rank's batch 8")
        dp.append({"loss": g["dp"]["loss"], "loss_err": loss_err,
                   "leaf_rel_err": leaf_err})
        tp_err = float((g["tp"]["logits"] - replicated).abs().max())
        if tp_err > PAR_TP_RTOL * scale:
            fail(f"gloo rank {r}: the TP forward is {tp_err} from the "
                 f"replicated one (logit scale {scale})")
        if g["tp"]["heads"] != [3] * 12 or g["tp"]["launches"] != expected(
                **per_forward):
            fail(f"gloo rank {r}: TP heads {g['tp']['heads']}, launches "
                 f"{g['tp']['launches']}")
        tp_rec.append({"max_abs_err": tp_err, "logit_scale": scale,
                       "heads_a_rank": 3, "qkv_width": g["tp"]["qkv_width"]})
        paths[f"dp_step_gloo_rank{r}"] = g["dp"]["launches"]
        paths[f"tp_forward_gloo_rank{r}"] = g["tp"]["launches"]
    res["gloo_dp"] = dp
    res["gloo_tp"] = tp_rec
    res["gloo_wait_s"] = wait_s
    print("parallel", json.dumps(res))

    # (a) the demo, (c) the evaluators, on the trained flagship
    fx = dict(np.load(SYNTHETIC_FIXTURE))
    model, _ = eval_load(torch, TRAINED_CKPTS["flagship"], torch.float32)
    res["demo"], ctrl_launches = demo_part(torch, model, fx, per_forward)
    paths["demo_controller_clicks"] = ctrl_launches
    res["evaluators"], eval_launches = evaluators_part(torch, model, fx)
    paths.update(eval_launches)
    del model
    res["s"] = time.time() - t_phase
    res["path_launches"] = paths
    print(f"phase 11m demo_parallel: {res['s']:.1f} s")
    return res


# -- phase 11n: the extended training loaders --------------------------------


def ext_loader(layout: str, template, **kw):
    """``layout``'s loader of ``data/datasets/extended.py`` on its tree,
    with ``template``'s augmentations (SBD's train set), the hierarchy
    sampler and ``EXT_STUFF_PROB`` where it takes one (the fixture's)."""
    from isegprobe_torch.data import datasets as ds
    from isegprobe_torch.data.points_sampler import MultiPointSampler

    kw = dict(augmentator=template.augmentator,
              points_sampler=MultiPointSampler(
                  24, prob_gamma=0.80, merge_objects_prob=0.15,
                  max_num_merged_objects=2, use_hierarchy=True),
              min_object_area=80, keep_background_prob=0.01, **kw)
    root = DATA_TREES / layout
    stuff = {"stuff_prob": EXT_STUFF_PROB}
    return {"coco_lvis": lambda: ds.CocoLvisDataset(root, **stuff, **kw),
            "lvis": lambda: ds.LvisDataset(root, **kw),
            "coco": lambda: ds.CocoDataset(root, **stuff, **kw),
            "ade20k": lambda: ds.ADE20kDataset(root, **stuff, **kw),
            "openimages": lambda: ds.OpenImagesDataset(root, **kw)}[
                layout]()


def ext_composed(template, **kw):
    """The ``ComposeDataset`` of the five loaders (the fixture's)."""
    from isegprobe_torch.data.compose_dataset import ComposeDataset

    members = [ext_loader(layout, template) for layout in EXT_LAYOUTS]
    return ComposeDataset(members, augmentator=template.augmentator,
                          points_sampler=members[0].points_sampler,
                          min_object_area=80, keep_background_prob=0.01,
                          **kw)


def extended_data_phase(torch) -> dict:
    """Main path 105, the extended training loaders (phase 11n of the
    module docstring): (a) decoding every file of the five trees, colour
    and unchanged; (b) the items of each loader and of the composed set
    (threads and processes) against JAX's digests; (c) the full-width SBD
    step on the composed batch against JAX's; (d) eight trainer steps fed
    by the composed set through the threaded loader. Returns the records
    and the path launches."""
    import zlib

    from isegprobe_torch.data import image_io
    from isegprobe_torch.data.loader import DataLoader, _stack, item_seed
    from isegprobe_torch.train import sbd_datasets

    t_phase = time.time()
    res: dict = {}
    fx = dict(np.load(EXT_FIXTURE))

    # (a) every file to cv2's pixels, in colour and unchanged
    t0 = time.time()
    for name, want, want_u in zip(fx["file_names"], fx["file_digests"],
                                  fx["file_digests_unchanged"]):
        if pixel_digest(image_io.read_bgr(DATA_TREES / name)) != want:
            fail(f"{name} decodes to other pixels than cv2.imread's")
        if pixel_digest(image_io.read_unchanged(DATA_TREES / name)) \
                != want_u:
            fail(f"{name} decodes to other pixels than cv2.imread("
                 "IMREAD_UNCHANGED)'s")
    decode_all_s = time.time() - t0
    jpegs = [DATA_TREES / n for n in fx["file_names"]
             if str(n).endswith(".jpg")]
    kinds = {"progressive": [], "baseline": []}
    for path in jpegs:
        data = path.read_bytes()
        kind = "progressive" if b"\xff\xc2" in data else "baseline"
        t0 = time.time()
        for _ in range(5):
            image_io.decode_bgr(data)
        kinds[kind].append(((time.time() - t0) / 5, path))
    res["decode"] = {"files": len(fx["file_names"]), "all_s": decode_all_s}
    for kind, rows in kinds.items():
        if not rows:
            fail(f"the extended trees hold no {kind} JPEG")
        res["decode"][f"{kind}_jpegs"] = len(rows)
        res["decode"][f"ms_per_{kind}_jpeg_median"] = 1e3 * float(
            np.median([r[0] for r in rows]))
        res["decode"][f"{kind}_shape"] = list(
            image_io.read_rgb(rows[0][1]).shape)
    print("extended_decode", json.dumps(res["decode"]))

    # (b) each loader's items against JAX's; ms an item a loader
    template, _ = sbd_datasets(DATA_TREES / "sbd")
    rec = {}
    for layout in EXT_LAYOUTS:
        ds = ext_loader(layout, template)
        salt = zlib.crc32(layout.encode())
        for row, seed in enumerate(DATA_SEEDS):
            t0 = time.time()
            got = [ds.get_item(p, item_seed(seed, salt, 0, p))
                   for p in range(len(ds))]
            took = time.time() - t0
            if [item_digest(it) for it in got] != list(
                    fx[f"items_{layout}"][row]):
                fail(f"{layout}: the items of seed {seed} differ from the "
                     "JAX items")
            if row == 0:
                rec[f"{layout}_ms_per_item"] = 1e3 * took / len(ds)
    # the composed set through 4 threads (seeds 0 and 1, one set) and 4
    # spawned processes (seed 0, a fresh set: LVIS shuffles an image's
    # annotations in place, so a set's items depend on its earlier draws,
    # as the fixture's do), batches of 4 so that no item is dropped
    for row, seed, processes in ((0, 0, False), (1, 1, False),
                                 (0, 0, True)):
        if not row:
            composed = ext_composed(template)
        mode = "processes" if processes else "threads"
        loader = DataLoader(composed, 4, shuffle=False,
                            num_workers=DATA_WORKERS, seed=seed,
                            salt="train", use_processes=processes)
        try:
            t0 = time.time()
            batches = list(loader)
            took = time.time() - t0
        finally:
            loader.shutdown()
        items = [{k: v[i] for k, v in b.items()} for b in batches
                 for i in range(len(b["images"]))]
        if [item_digest(it) for it in items] != list(
                fx["items_compose"][row]):
            fail(f"the composed items of seed {seed} ({mode}) differ "
                 "from the JAX items")
        rec[f"compose_seed{seed}_{mode}_ms_per_item"] = \
            1e3 * took / len(items)
    res["items"] = rec
    print("extended_items", json.dumps(rec))

    # (c) the full-width SBD step on the composed batch against JAX's
    composed = ext_composed(template)  # fresh, as the fixture's
    salt = zlib.crc32(b"train")
    positions = [int(p) for p in fx["step_positions"]]
    items = [composed.get_item(p, item_seed(0, salt, 0, p))
             for p in positions]
    if [item_digest(it) for it in items] != list(fx["step_item_digests"]):
        fail("the step batch's items differ from the JAX items")
    batch_np = _stack(items)
    sbd_arg = f"DATASETS.SBD_PATH={DATA_TREES / 'sbd'}"
    trainer, _, step = step_vs_jax(
        torch, "sbd_dinov2_noup", batch_np, fx["step_losses"],
        fx["step_digest_names"], fx["step_digests"],
        FORWARD_LAUNCHES["flagship"], [sbd_arg])
    trainer.shutdown()
    del trainer
    step["positions"] = positions
    print("extended_step_vs_jax", json.dumps(step))
    res["step_vs_jax"] = step

    # (d) eight trainer steps fed by the composed set (threads), clicks
    per_step = {"train": []}
    trainer = build(["model=sbd_dinov2_noup", sbd_arg,
                     f"dataloader.workers={DATA_WORKERS}",
                     f"exp_path={scratch()}", "image_dump_interval=0"],
                    on_step=step_checker("extended_data",
                                         FORWARD_LAUNCHES["flagship"],
                                         per_step))
    trainer.train_data.shutdown()
    trainer.train_data = DataLoader(
        ext_composed(template, epoch_len=EXT_STEPS * TRAIN_BATCH),
        TRAIN_BATCH, shuffle=True, num_workers=DATA_WORKERS,
        seed=trainer.seed, salt="train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.time()
    trainer.training(0)
    wall = time.time() - t0
    trainer.shutdown()
    st = trainer.stats
    if len(st["num_iters"]) != EXT_STEPS:
        fail(f"extended_data: the epoch ran {len(st['num_iters'])} steps, "
             f"expected {EXT_STEPS}")
    if not np.isfinite(trainer.epoch_losses).all():
        fail(f"extended_data: non-finite losses {trainer.epoch_losses}")
    launches = {k: sum(c[k] for c in per_step["train"]) for k in KERNELS}
    wait = np.asarray(st["data_wait_s"]) * 1e3
    res["train"] = {
        "steps": EXT_STEPS, "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
        "workers": DATA_WORKERS, "wall_s": wall,
        "num_iters": st["num_iters"],
        "ms_per_step_median": 1e3 * float(np.median(st["step_wall_s"])),
        "device_ms_per_step_median": float(np.median(
            st["step_device_ms"])),
        "data_wait_ms_median": float(np.median(wait)),
        "peak_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
        "epoch_loss": float(trainer.epoch_losses[-1]),
        "launches": launches}
    print("extended_train", json.dumps(res["train"]))
    del trainer
    res["s"] = time.time() - t_phase
    res["path_launches"] = {
        "extended_step_vs_jax": step["launches"],
        "extended_train": expected(**{k: v for k, v in launches.items()
                                      if v})}
    print(f"phase 11n extended_data: {res['s']:.1f} s")
    return res


def _parent_steps(torch, argv, gb, per_step: dict, paths: dict,
                  res: dict) -> tuple:
    """(b) of phase 11m in this process, while the gloo ranks run: the
    replicated forward and the plain step (one rank, batch 8), and the same
    step through an NCCL group of one (``HashStore``), bitwise. Both steps
    run with cuDNN's deterministic algorithms: with cuDNN's defaults the
    two steps' losses were equal and their leaves 1.7e-7 of a leaf's norm
    apart on the H100, the convolutions' weight gradients being free to
    add in another order from call to call, which is not what the group
    of one is held to.
    Returns (plain loss, plain leaves, replicated logits)."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        return _parent_steps_deterministic(torch, argv, gb, per_step, paths,
                                           res)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _parent_steps_deterministic(torch, argv, gb, per_step: dict,
                                paths: dict, res: dict) -> tuple:
    import torch.distributed as dist

    from isegprobe_torch.parallel.mesh import make_mesh

    def leaves(trainer):
        return {n: p.detach().cpu() for n, p in
                trainer.model.named_parameters() if p.requires_grad}

    plain = build(argv)
    batch = plain._upload(gb)
    with torch.no_grad():
        images = batch["images"].float() / 255.0
        net = torch.cat([images, torch.zeros_like(images[..., :1])], -1)
        replicated = plain.model(net, batch["points"])["instances"].cpu()
    zero_counters()
    plain_loss = float(plain._step(batch, PAR_ITERS)[0])
    torch.cuda.synchronize()
    if counters() != per_step:
        fail(f"the plain step launched {counters()}, expected {per_step}")
    plain_leaves = leaves(plain)
    plain.shutdown()
    del plain
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(device="cuda:0")
        nccl = build(argv, mesh=mesh)
        zero_counters()
        nccl_loss = float(nccl._step(nccl._upload(gb), PAR_ITERS)[0])
        torch.cuda.synchronize()
        paths["dp_step_nccl_group_of_one"] = counters()
        nccl_leaves = leaves(nccl)
        nccl.shutdown()
        del nccl
    finally:
        dist.destroy_process_group()
    if paths["dp_step_nccl_group_of_one"] != per_step:
        fail(f"the NCCL group of one's step launched "
             f"{paths['dp_step_nccl_group_of_one']}, expected {per_step}")
    bitwise = nccl_loss == plain_loss and all(
        torch.equal(nccl_leaves[k], v) for k, v in plain_leaves.items())
    if not bitwise:
        fail("the NCCL group of one's step is not bitwise the plain step: "
             f"loss {nccl_loss} vs {plain_loss}, leaves "
             f"{_leaf_errors(nccl_leaves, plain_leaves)}")
    res["nccl_group_of_one"] = {"loss": nccl_loss, "bitwise": bitwise}
    return plain_loss, plain_leaves, replicated


def _flat(tree, prefix=""):
    """(path, leaf) of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def variant_sweep(torch, F) -> tuple:
    """Kernels F (nodiv) and G (merged) against their plain versions and
    bit for bit against each other and kernel A, at B=2, at the sweep's
    shape and at a ragged small shape; then
    main path 7, the sweep through its package entry, with every counter set
    to 0 just before and read just after: each variant launches its kernel
    exactly ``LAUNCHES_PER_VARIANT`` times. The checks at the sweep's shape
    take their kernel times from the sweep's records. Returns (the checks,
    the sweep's records, its launches)."""
    from isegprobe_torch.ops import attention, attn_variants
    from isegprobe_torch.scripts import bench_attn_variants as bav

    variant_checks = []
    for i, (b, n, heads) in enumerate(((2, 1025, 6), (bav.BATCH, bav.N,
                                                      bav.HEADS),
                                       (3, 77, 4))):
        for dtype in ("float32", "bfloat16"):
            variant_checks += variant_cases(
                torch, F, attention, attn_variants, b, n, heads, dtype,
                seed=40 + i, timed=b == bav.BATCH)
    for c in variant_checks:
        print("check", json.dumps(c))
    bad = [c for c in variant_checks if not c["ok"]]
    if bad:
        fail(f"kernel F or G disagrees with its plain version, or G with F "
             f"or F with kernel A bit for bit: {bad}")
    zero_counters()
    sweep = bav.main()
    sweep_launches = counters()
    per = bav.LAUNCHES_PER_VARIANT
    want = expected(**{k: per * sum(r["kernel"] == k for r in sweep)
                       for k in ("mha_qkv", "mha_qkv_nodiv",
                                 "mha_qkv_merged")})
    if sweep_launches != want:
        fail(f"the sweep launched {sweep_launches}, expected {want}")
    bad = [r for r in sweep if not r["ok"] or r["launches"] != per
           or not r["ms"] > 0]
    if bad:
        fail(f"sweep variants out of tolerance or untimed: {bad}")
    print("sweep", json.dumps({"records": sweep, "launches": sweep_launches}))
    ms = {(r["dtype"], r["variant"]): r["ms"] for r in sweep}
    for c in variant_checks:
        if "plain_ms" in c:
            suffix = "_ebf16" if c["expdt"] == "bfloat16" else ""
            c["ms"] = ms[(c["dtype"],
                          c["kernel"].removeprefix("mha_qkv_")
                          + f"{c['tile']}{suffix}")]
            c["timing"] = "cuda_graph (sweep)"
    return variant_checks, sweep, sweep_launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every result to this JSON "
                        "file")
    args = parser.parse_args()
    # the CLIs read configs/*.yaml at the working directory, as the root's do
    os.chdir(Path(__file__).resolve().parent)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.clicker import Clicker
    from isegprobe_torch.inference.evaluation import (
        evaluate_dataset,
        evaluate_sample,
        latency_percentiles,
    )
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_torch.models.vit import init_params
    from isegprobe_torch.ops import attention, cuda_lib, edt, jbu, layernorm
    from isegprobe_torch.ops.sample import inverse_paste
    from isegprobe_torch.scripts import bench_edt

    t_start = time.time()
    results: dict = {}
    phase_s: dict = {}  # seconds of each phase, from the end of the last

    def done(phase: str) -> None:
        phase_s[phase] = time.time() - t_start - sum(phase_s.values())

    # 1. the card
    card = nvidia_smi()
    print(card)
    results["card"] = card
    results["device_name"] = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build every kernel from the checkout's sources
    t0 = time.time()
    reports = cuda_lib.build()
    results["build_s"] = time.time() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C7515" in line:
                print(f"[ptxas {name}] {line.strip()}")
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{results['build_s']:.1f} s")
    # wgmma serialized by ptxas (C7515) in the sources built by this run
    results["ptxas_c7515_lines"] = sum(
        "C7515" in line for log in reports.values()
        for line in log.splitlines())
    print(f"ptxas C7515 lines: {results['ptxas_c7515_lines']} (sources "
          f"built in this run: {sorted(reports)})")
    # kernel E's tiling and resources as its library reports them on this
    # card (whether or not this run built it: blocks an SM from CUDA's
    # occupancy calculator, local bytes for stack and spills), and its ptxas
    # entry where this run built it
    jbu_ptxas = next((v for n, v in cuda_lib.ptxas_entries(
        reports.get("jbu", "")).items() if "jbu_kernel" in n), None)
    jbu_config = jbu.kernel_config()
    results["jbu_ptxas"], results["jbu_config"] = jbu_ptxas, jbu_config
    print(f"kernel E: {json.dumps(jbu_config)}; "
          f"ptxas {json.dumps(jbu_ptxas)}")
    if "jbu" in reports and jbu_ptxas is None:
        fail("kernel E has no entry in its ptxas report")
    if jbu_config["local_bytes"] or (jbu_ptxas and (
            jbu_ptxas["spill_stores"] or jbu_ptxas["spill_loads"])):
        fail(f"kernel E spills: {jbu_config}, ptxas {jbu_ptxas}")
    if jbu_config["blocks_per_sm"] < 2:
        fail(f"kernel E fits fewer than the two blocks an SM of its design: "
             f"{jbu_config}")
    # kernel C's layout at the loop's row width, as its library reports it
    edt_ptxas = next((v for n, v in cuda_lib.ptxas_entries(
        reports.get("edt", "")).items() if "row_envelope_kernel" in n), None)
    edt_config = edt.kernel_config(EDT_SHAPE[-1])
    results["edt_ptxas"], results["edt_config"] = edt_ptxas, edt_config
    print(f"kernel C: {json.dumps(edt_config)}; "
          f"ptxas {json.dumps(edt_ptxas)}")
    if "edt" in reports and edt_ptxas is None:
        fail("kernel C has no entry in its ptxas report")
    if edt_config["local_bytes"] or (edt_ptxas and (
            edt_ptxas["spill_stores"] or edt_ptxas["spill_loads"])):
        fail(f"kernel C spills: {edt_config}, ptxas {edt_ptxas}")
    # kernel I's four instantiations (output f32 / bf16 x bias f32 / bf16):
    # no local bytes, and no wgmma serialized (C7515) in quant.cu
    quant_log = reports.get("quant", "")
    gemm_ptxas = {n: v for n, v in cuda_lib.ptxas_entries(quant_log).items()
                  if "int8_gemm_kernel" in n}
    results["int8_gemm_ptxas"] = list(gemm_ptxas.values())
    results["quant_c7515_lines"] = sum("C7515" in line
                                       for line in quant_log.splitlines())
    print(f"kernel I: ptxas {json.dumps(results['int8_gemm_ptxas'])}; "
          f"quant.cu C7515 lines {results['quant_c7515_lines']}")
    if "quant" in reports and len(gemm_ptxas) != 4:
        fail(f"kernel I has {len(gemm_ptxas)} ptxas entries, not 4")
    if results["quant_c7515_lines"] or any(
            v["stack_bytes"] or v["spill_stores"] or v["spill_loads"]
            for v in gemm_ptxas.values()):
        fail(f"kernel I spills or is serialized: {gemm_ptxas}, "
             f"{results['quant_c7515_lines']} C7515 lines")
    # B's backward: every instantiation (the three widths a lane holds, dx
    # alone and with dweight and dbias, each dtype pair and load path)
    # without a spill, up to D = 1024 with its dweight / dbias sums
    bwd_ptxas = {n: v for n, v in cuda_lib.ptxas_entries(
        reports.get("layernorm", "")).items() if "ln_bwd" in n}
    results["layernorm_bwd_ptxas"] = {
        "entries": len(bwd_ptxas),
        "max_registers": max((v["registers"] or 0
                              for v in bwd_ptxas.values()), default=None),
        "spill_bytes": sum(v["spill_stores"] + v["spill_loads"]
                           for v in bwd_ptxas.values())}
    print(f"kernel B backward: ptxas "
          f"{json.dumps(results['layernorm_bwd_ptxas'])}")
    if "layernorm" in reports and (not bwd_ptxas or any(
            v["stack_bytes"] or v["spill_stores"] or v["spill_loads"]
            for v in bwd_ptxas.values())):
        fail(f"kernel B's backward spills: {bwd_ptxas}")

    # 3. kernels A and B against their plain versions, timed beside them;
    # batch 16 is the device loop's forward (8 lanes, flip TTA)
    checks = []
    for dtype in ("float32", "bfloat16"):
        checks += attention_case(torch, F, attention, 2, 1025, 6, 64, dtype,
                                 seed=1, all_plans=True)
        checks.append(layernorm_case(torch, F, layernorm, (2, 1025), 384,
                                     dtype, seed=2))
        checks += attention_case(torch, F, attention, 2, 1025, 8, 32, dtype,
                                 seed=3, all_plans=True)
        checks += attention_case(torch, F, attention, 1, 513, 2, 128, dtype,
                                 seed=4, all_plans=True)
        checks += attention_case(torch, F, attention, 2 * LOOP_BATCH, 1025,
                                 6, 64, dtype, seed=5, all_plans=True)
    # an odd head width takes the element-load path in bf16
    checks += attention_case(torch, F, attention, 2, 1025, 3, 13,
                             "bfloat16", seed=7, all_plans=True)
    checks.append(layernorm_case(torch, F, layernorm, (2 * LOOP_BATCH, 1025),
                                 384, "float32", seed=6))

    # 4. kernel C against its plain version, bitwise: the three inputs of
    # bench_edt.py at the device loop's shape (random first: the kernels
    # line reads it), random masks at two more shapes, and the rest of its
    # domain (W = 4096 and 1, sentinel rows, single sources, g > 4096,
    # G > 2^30)
    cuda = torch.device("cuda")
    for i, (kind, shape) in enumerate((
            ("random", EDT_SHAPE), ("clicker", EDT_SHAPE),
            ("adversarial", EDT_SHAPE), ("random", (64, 64)),
            ("random", (3, 5, 37, 333)))):
        checks.append(edt_case(torch, edt, bench_edt.column_input(
            kind, shape, cuda, seed=10 + i), kind))
    for kind, gcol in bench_edt.domain_inputs(cuda, seed=15).items():
        checks.append(edt_case(torch, edt, gcol, kind, timed=False))

    # kernel D at LoftUp's slab (64 rows of 448 queries against 32² keys, 4
    # heads of 101) at B=2 and at the family loop's batch (flip TTA doubles
    # it), at a ragged Nq and Nk, and at dh=64; kernel E at the four JBU
    # stages at B=2, the last at the loop's batch, at a width and height
    # that are no multiple of 16, at C=100; at the tiling's edges: W one
    # past a strip of 8 and H one past a tile of 8 (and 16) rows, C=70 (no
    # multiple of 4: 4-byte copies), K=1, H = W = 4, and bases off 16-byte
    # alignment
    loop_fwd = 2 * FAMILY_BATCH
    for i, (b, nq, nk, heads, dh, dtype) in enumerate((
            (2, 64 * 448, 1024, 4, 101, "float32"),
            (2, 64 * 448, 1024, 4, 101, "bfloat16"),
            (loop_fwd, 64 * 448, 1024, 4, 101, "float32"),
            (loop_fwd, 64 * 448, 1024, 4, 101, "bfloat16"),
            (2, 1000, 777, 4, 101, "float32"),
            (2, 1000, 777, 4, 101, "bfloat16"),
            (2, 4096, 1024, 6, 64, "float32"),
            (2, 4096, 1024, 6, 64, "bfloat16"))):
        checks += cross_attention_case(torch, F, attention, b, nq, nk, heads,
                                       dh, dtype, seed=20 + i,
                                       all_plans=True)
    for i, (b, h, w, c) in enumerate((
            (2, 64, 64, 384), (2, 128, 128, 384), (2, 256, 256, 384),
            (2, 512, 512, 384), (loop_fwd, 512, 512, 384),
            (1, 60, 90, 384), (2, 64, 64, 100))):
        checks.append(jbu_case(torch, jbu, b, h, w, c, 32, seed=30 + i))
    for i, (b, h, w, c, k, aligned) in enumerate((
            (1, 17, 41, 384, 32, True), (2, 64, 64, 70, 32, True),
            (2, 40, 24, 384, 1, True), (3, 4, 4, 384, 32, True),
            (2, 33, 50, 384, 32, False))):
        checks.append(jbu_case(torch, jbu, b, h, w, c, k, seed=40 + i,
                               aligned=aligned))
    for c in checks:
        print("check", json.dumps(c))
    results["checks"] = checks
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # 5. full-width flagship forward: card vs CPU, launches per forward
    cfg = flagship_config((448, 448))
    model = init_params(iSegProbeModel(**cfg), seed=0).eval()
    results["classifier_bias"] = calibrate_classifier(torch, model, 448)
    cpu_model = iSegProbeModel(**cfg, device="cpu").eval()
    cpu_model.load_state_dict(model.state_dict())
    torch.set_num_threads(8)
    img_d, pts_d, logits, results["forward"] = forward_vs_cpu(
        torch, model, cpu_model, 448, FORWARD_LAUNCHES["flagship"],
        "flagship")

    # 6. main path 1: the host predictor answers NoC clicks
    scenes = [scene(11), scene(12)]
    predictor = Predictor(model, target_size=(448, 448), with_flip=True,
                          net_clicks_limit=20)
    evaluate_sample(*scene(10), predictor, max_iou_thr=2.0, max_clicks=1)
    click_s = time_clicks(predictor)
    sample_s: list = []  # per sample: wall time / clicks, clicker included
    zero_counters()
    all_ious, _ = evaluate_dataset(Scenes(scenes), predictor,
                                   latencies=sample_s, max_iou_thr=0.95,
                                   max_clicks=MAX_CLICKS,
                                   callback=check_probs)
    launches = counters()
    n_clicks = sum(len(ious) for ious in all_ious)
    if len(all_ious) != len(scenes) or not all(
            1 <= len(ious) <= MAX_CLICKS for ious in all_ious):
        fail("predictor trajectories have bad lengths")
    if launches != expected(mha_qkv=12 * n_clicks,
                            layernorm=25 * n_clicks):
        fail(f"main path launches {launches} for {n_clicks} clicks")

    # the first click of scene 0 against the CPU predictor
    cpu_pred = Predictor(cpu_model, target_size=(448, 448), with_flip=True,
                         net_clicks_limit=20, device="cpu")
    _, _, cpu_probs = evaluate_sample(*scenes[0], cpu_pred, max_iou_thr=2.0,
                                      max_clicks=1)
    gpu_pred = Predictor(model, target_size=(448, 448), with_flip=True,
                         net_clicks_limit=20)
    _, _, gpu_probs = evaluate_sample(*scenes[0], gpu_pred, max_iou_thr=2.0,
                                      max_clicks=1)
    probs_err = float(np.abs(gpu_probs - cpu_probs).max())
    if probs_err > PROBS_ATOL:
        fail(f"first-click probabilities differ from the CPU path by "
             f"{probs_err}")

    # one bf16 forward, params cast as evaluate.py casts them
    model_bf16, bf16_rec = bf16_forward(torch, model, cfg, img_d, pts_d,
                                        logits, FORWARD_LAUNCHES["flagship"],
                                        "flagship")
    noc = {"clicks": n_clicks,
           "ious": [[float(v) for v in ious] for ious in all_ious],
           "per_click": latency_percentiles(click_s),
           "per_click_protocol": latency_percentiles(sample_s),
           "main_path_launches": launches,
           "first_click_probs_err_vs_cpu": probs_err,
           "bf16_forward": bf16_rec}
    print("noc", json.dumps(noc))
    print(f"p50 per click: {noc['per_click']['p50_ms']:.3f} ms over "
          f"{n_clicks} clicks (f32, fixed-448 ZoomIn, flip TTA)")
    results["noc"] = noc

    # 7. the device clicker against the host scipy clicker, lane by lane
    gts, preds, ncs = click_lanes(32, (512, 640), seed=3)
    with torch.inference_mode():
        is_pos, cy, cx = edt.next_click_from_error(
            *(torch.from_numpy(a).cuda() for a in (gts == 1, preds, ncs,
                                                   gts != -1)))
    got = list(zip(is_pos.tolist(), cy.tolist(), cx.tolist()))
    want = []
    for gt, pred, nc in zip(gts, preds, ncs):
        clicker = Clicker(gt)
        clicker.not_clicked_map = nc.copy()
        click = clicker._get_next_click(pred)
        want.append((click.is_positive, *click.coords))
    mismatched = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    results["clicker"] = {"lanes": len(got), "mismatched": mismatched,
                          "positives": int(sum(p for p, _, _ in got))}
    print("clicker", json.dumps(results["clicker"]))
    if mismatched:
        fail(f"device clicks differ from the host clicker in lanes "
             f"{mismatched}: {[(got[i], want[i]) for i in mismatched]}")

    # 8. main path 2: the batched on-device NoC loop at full width
    loop_scenes = [scene(20 + i) for i in range(LOOP_JOBS)]

    def evaluator(m, batch, target, **kw):
        kw.setdefault("max_clicks", LOOP_CLICKS)
        return device_eval.make_device_evaluator(
            m, target_size=(448, 448), batch_size=batch, target_iou=target,
            net_clicks_limit=20, **kw)

    probe = device_eval.evaluate_dataset_device(
        evaluator(model, LOOP_BATCH, 2.0), Scenes(loop_scenes))
    target, stops = pick_target(probe, LOOP_CLICKS)
    print(f"target IoU {target:.6f}: lanes stop at clicks {stops}")
    run8 = evaluator(model, LOOP_BATCH, target)
    lane_s: list = []
    zero_counters()
    t0 = time.time()
    got8 = device_eval.evaluate_dataset_device(run8, Scenes(loop_scenes),
                                               sample_times=lane_s)
    loop_wall = time.time() - t0
    loop_launches = counters()
    want_launches = expected(**{k: v * run8.steps
                                for k, v in PER_STEP.items()})
    if loop_launches != want_launches:
        fail(f"device loop launched {loop_launches} in {run8.steps} steps, "
             f"expected {want_launches}")
    lengths = [len(a) for a in got8]
    if lengths != stops or len(set(lengths)) < 2:
        fail(f"lanes stopped at {lengths}, expected {stops} (at least two "
             f"different clicks)")
    if len(lane_s) != LOOP_JOBS:
        fail(f"{len(lane_s)} sample times for {LOOP_JOBS} samples")
    run1 = evaluator(model, 1, target)
    got1 = device_eval.evaluate_dataset_device(run1, Scenes(loop_scenes))
    err_b1 = same_trajectories(got8, got1, LOOP_IOU_TOL, "B=8 vs B=1")
    host_idx = sorted({int(np.argmin(lengths)), int(np.argmax(lengths))})
    host_pred = Predictor(model, target_size=(448, 448), with_flip=True,
                          net_clicks_limit=20)
    host = [evaluate_sample(*loop_scenes[i], host_pred, max_iou_thr=target,
                            pred_thr=0.49, max_clicks=LOOP_CLICKS)[1]
            for i in host_idx]
    err_host = same_trajectories([got8[i] for i in host_idx], host,
                                 LOOP_IOU_TOL, "device loop vs Predictor")
    loop = {"jobs": LOOP_JOBS, "batch": LOOP_BATCH, "target_iou": target,
            "lengths": lengths, "steps": run8.steps,
            "host_reads": run8.host_reads, "launches": loop_launches,
            "wall_s": loop_wall, "sample_s": lane_s,
            "ious": [[float(v) for v in a] for a in got8],
            "max_iou_diff_b8_vs_b1": err_b1,
            "host_compared": host_idx, "max_iou_diff_vs_host": err_host}
    print("device_loop", json.dumps({k: v for k, v in loop.items()
                                     if k not in ("ious", "sample_s")}))
    results["device_loop"] = loop

    # 9. no hidden syncs: one whole device-loop evaluation of the first
    # chunk under the sync debugger, lifted only around the allowed reads
    chunk = first_chunk(torch, device_eval, loop_scenes, LOOP_BATCH)
    results["sync_check"] = sync_checked_run(torch, run8, chunk,
                                             got8[:LOOP_BATCH], "flagship")
    print("sync_check", json.dumps(results["sync_check"]))

    # 10. the trunk cache at full width: after_backbone injection
    cfg_ab = flagship_config((448, 448))
    cfg_ab["backbone_cfg"]["params"]["feats_injection_mode"] = \
        "after_backbone"
    model_ab = iSegProbeModel(**cfg_ab).eval()
    model_ab.load_state_dict(model.state_dict())
    calibrate_classifier(torch, model_ab, 448)  # clicks join after it
    cache_scenes = Scenes(loop_scenes[:4])
    cached = evaluator(model_ab, 4, 2.0, max_clicks=5)
    uncached = evaluator(model_ab, 4, 2.0, max_clicks=5, trunk_cache="off")
    if not cached.use_cache or uncached.use_cache:
        fail("trunk_cache='auto' did not pick the cache for after_backbone")
    got_c = device_eval.evaluate_dataset_device(cached, cache_scenes)
    want_c = device_eval.evaluate_dataset_device(uncached, cache_scenes)
    cache = {"max_iou_diff": same_trajectories(got_c, want_c, CACHE_TOL,
                                               "cached vs uncached trunk"),
             "ious": [[float(v) for v in a] for a in got_c],
             "steps": cached.steps,
             "trunk_recomputes": cached.trunk_recomputes,
             "host_reads": cached.host_reads}
    print("trunk_cache", json.dumps(cache))
    if not 0 < cached.trunk_recomputes < cached.steps:
        fail(f"the trunk was recomputed on {cached.trunk_recomputes} of "
             f"{cached.steps} clicks: the ROI never moved, or moved on "
             f"every click, so the cache was not exercised")
    print(f"trunk recomputed on {cache['trunk_recomputes']} of "
          f"{cache['steps']} clicks")
    results["trunk_cache"] = cache

    # 11. throughput of the device loop beside the host protocol, and the
    # split of one f32 B=8 loop step
    thr_scenes = Scenes([scene(20 + i) for i in range(16)])
    throughput = []
    for dtype, batch in (("float32", 8), ("bfloat16", 8), ("bfloat16", 16)):
        m = model if dtype == "float32" else model_bf16
        device_eval.evaluate_dataset_device(  # warm-up: per-device constants
            evaluator(m, batch, target, max_clicks=1),
            Scenes(thr_scenes.scenes[:batch]))
        run = evaluator(m, batch, target)
        torch.cuda.synchronize()
        t0 = time.time()
        res = device_eval.evaluate_dataset_device(run, thr_scenes)
        wall = time.time() - t0
        clicks = sum(len(a) for a in res)
        throughput.append({
            "dtype": dtype, "batch": batch, "jobs": len(thr_scenes),
            "steps": run.steps, "wall_s": wall, "clicks": clicks,
            "lane_clicks_per_s": clicks / wall,
            "driven_lane_steps_per_s": run.steps * batch / wall,
            "ms_per_step": 1e3 * wall / run.steps})
        print("throughput", json.dumps(throughput[-1]))
    host_p50 = noc["per_click_protocol"]["p50_ms"]
    print(f"host protocol p50 {host_p50:.3f} ms per click "
          f"({1e3 / host_p50:.2f} clicks/s) vs device loop " + ", ".join(
              f"{t['dtype']} B={t['batch']}: {t['lane_clicks_per_s']:.2f} "
              f"lane-clicks/s, {t['ms_per_step']:.3f} ms/step"
              for t in throughput))
    results["throughput"] = throughput

    with torch.inference_mode():
        st = run8._init_state(*chunk)
        sel, pts_full = run8._select(st)
        crops, pts = run8._crop_points(st["image"], st["prev"], sel["roi"],
                                       pts_full)
        step_logits = model(crops, pts)["instances"]
        split = {
            "clicker_ms": time_ms(torch, lambda: edt.next_click_from_error(
                st["gt"], st["prev"][..., 0] > 0.49, st["not_clicked"],
                st["not_ignore"]))[0],
            "select_ms": time_ms(torch, lambda: run8._select(st))[0],
            "crop_ms": time_ms(torch, lambda: run8._crop_points(
                st["image"], st["prev"], sel["roi"], pts_full))[0],
            "forward_ms": time_ms(torch, lambda: model(crops, pts),
                                  reps=5, rounds=3, graph=False)[0],
            "paste_iou_ms": time_ms(torch, lambda: run8._score(
                st, inverse_paste(
                    run8._merge_flip(step_logits, LOOP_BATCH), sel["roi"],
                    tuple(st["gt"].shape[1:]))))[0],
        }
        # kernel C on this step's own column pass (the clicker's fn and fp
        # maps, padded with background), as next_click_from_error builds it
        pred = st["prev"][..., 0] > 0.49
        err = torch.stack([st["gt"] & ~pred, ~st["gt"] & pred], 1)
        err &= st["not_ignore"][:, None]
        fg = err.new_zeros((*err.shape[:-2], err.shape[-2] + 2,
                            err.shape[-1] + 2))
        fg[..., 1:-1, 1:-1] = err
        gcol = edt._column_pass(~fg).contiguous()
        split["row_envelope_ms"] = time_ms(
            torch, lambda: edt.row_envelope(gcol))[0]
        split["row_envelope_shape"] = list(gcol.shape)
        if not torch.equal(edt.row_envelope(gcol),
                           edt._row_envelope_plain(gcol)):
            fail("kernel C differs from its plain version on the loop's "
                 "own error maps")
    split["loop_ms_per_step"] = throughput[0]["ms_per_step"]
    print("step_split", json.dumps(split))
    results["step_split"] = split

    done("1-11 build, kernels, flagship")
    # 11b. the trained probes against the JAX package's results
    trained = trained_phase(torch, cuda)
    shared = trained.pop("shared")
    results["trained"] = {k: v for k, v in trained.items() if k != "checks"}
    for c in trained["checks"]:
        print("check", json.dumps(c))
    checks += trained["checks"]
    bad = [c for c in trained["checks"] if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    done("11b trained")
    # 11c. training: A and B under autograd, the data layer, the step
    # against JAX's, one epoch through the command line's trainer
    training = training_phase(torch)
    results["training"] = {k: v for k, v in training.items()
                           if k != "checks"}
    for c in training["checks"]:
        print("check", json.dumps(c))
    checks += [c for c in training["checks"] if not c.get("autograd")]
    bad = [c for c in training["checks"] if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    done("11c training")
    # 11d. the other backbones: the trained MaskCLIP probe against JAX's
    # results, the drawn DINO key probe, SimpleViT and LiFT probes, the
    # linear and simple_conv heads
    others = other_backbones_phase(torch)
    results["other_backbones"] = {k: v for k, v in others.items()
                                  if k != "checks"}
    for c in others["checks"]:
        print("check", json.dumps(c))
    checks += others["checks"]
    bad = [c for c in others["checks"] if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    done("11d other_backbones")
    # 11e. the RITM adaptive protocol and continuous batching on the
    # trained flagship
    ritm = ritm_and_refill_phase(torch, cuda, shared)
    del shared
    results["ritm_and_refill"] = {k: v for k, v in ritm.items()
                                  if k != "checks"}
    for c in ritm["checks"]:
        print("check", json.dumps(c))
    checks += ritm["checks"]
    bad = [c for c in ritm["checks"] if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    done("11e ritm_and_refill")
    # 11f. training the other Synthetic probes: D and E under autograd,
    # the LoftUp and JBU steps against JAX's, every other script through
    # the command line
    family_training = family_training_phase(torch)
    results["family_training"] = family_training

    done("11f family_training")
    # 11g. mixed-precision training: A, B, D and E under autograd in bf16,
    # the bf16 steps against JAX's, bf16 command-line runs, 448² with and
    # without remat, resuming, click_models
    bf16_training = bf16_training_phase(torch)
    results["bf16_training"] = bf16_training

    done("11g bf16_training")
    # 11h. the paper's data: decoding, the SBD items and steps, the
    # evaluate CLI on the five evaluation trees
    data = data_phase(torch)
    results["data"] = data

    done("11h data")
    # 11i. the rest of the host protocol: the native host EDT, BRS
    # through the evaluate CLI, CropsPredictor, click-model ensembles, A,
    # B, D and E under autograd at batch 1
    brs_res = brs_phase(torch, F)
    results["brs"] = brs_res

    done("11i brs")
    # 11j. published weights: the converters, PRETRAINED_MODELS, LoftUp's
    # padded layout and fused head, the CLIP text tower
    converted = converted_weights_phase(torch, F)
    results["converted_weights"] = {k: v for k, v in converted.items()
                                    if k != "checks"}

    done("11j converted_weights")
    # 11k. a researcher's outputs: the evaluate CLI's dumps, IoU pickles and
    # results.txt, the feature probe, the train CLI's run logs, events and
    # image dumps
    outputs = run_outputs_phase(torch)
    results["run_outputs"] = outputs

    done("11k run_outputs")
    # 11l. int8 W8A8 serving: kernels H and I bitwise, the trained
    # flagship's int8 forward, device loop and host clicks against JAX's
    # int8 results, MaskCLIP, the DINO key probe and LoftUp in int8
    int8 = int8_phase(torch, F)
    results["int8"] = {k: v for k, v in int8.items() if k != "checks"}
    for c in int8["checks"]:
        print("check", json.dumps(c))
    checks += int8["checks"]
    bad = [c for c in int8["checks"] if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    done("11l int8")
    # 11m. the interactive demo and parallel/: the demo's controller
    # against the host Predictor, DP and TP on torch.distributed, the
    # multi-device evaluators and the evaluate CLI's device_mesh
    demo_parallel = demo_parallel_phase(torch)
    results["demo_parallel"] = demo_parallel

    done("11m demo_parallel")
    # 11n. the extended training loaders: decoding, the items of the five
    # loaders and of their composition, the step against JAX's, eight
    # trainer steps fed by the composed set
    extended = extended_data_phase(torch)
    results["extended_data"] = {k: v for k, v in extended.items()
                                if k != "path_launches"}

    done("11n extended_data")
    # 12. the learned-upsampler families (main paths 3-6)
    families = {name: learned_family(torch, name) for name in UPSAMPLERS}
    results["families"] = families

    done("12 families")
    # 13. kernels F and G, and main path 7: the attention-variant sweep
    variant_checks, sweep, sweep_launches = variant_sweep(torch, F)
    checks += variant_checks
    results["sweep"] = {"records": sweep, "launches": sweep_launches}

    # 14. the kernels of the paths, at the device loops' shapes (f32; A, F
    # and G also in bf16 at the sweep's shape)
    from isegprobe_torch.scripts import bench_attn_variants as bav
    sweep_shape = [bav.BATCH, bav.N, 3 * 64 * bav.HEADS]
    sources = {
        "mha_qkv": ("isegprobe_torch/csrc/attention.cu",
                    "isegprobe_tpu/ops/attention.py:172",
                    [2 * LOOP_BATCH, 1025, 1152]),
        "layernorm": ("isegprobe_torch/csrc/layernorm.cu",
                      "isegprobe_tpu/ops/layernorm.py:70",
                      [2 * LOOP_BATCH, 1025, 384]),
        "edt_row_envelope": ("isegprobe_torch/csrc/edt.cu",
                             "isegprobe_tpu/ops/edt.py:168",
                             list(EDT_SHAPE)),
        "mha": ("isegprobe_torch/csrc/mha.cu",
                "isegprobe_tpu/ops/attention.py:319",
                [[loop_fwd, 64 * 448, 4, 101], [loop_fwd, 1024, 4, 101]]),
        "jbu_filter": ("isegprobe_torch/csrc/jbu.cu",
                       "isegprobe_tpu/ops/jbu_kernel.py:188",
                       [loop_fwd, 512, 512, 384]),
        "mha_qkv_nodiv": ("isegprobe_torch/csrc/attn_variants.cu",
                          "scripts/bench_attn_variants.py:101",
                          sweep_shape),
        "mha_qkv_merged": ("isegprobe_torch/csrc/attn_variants.cu",
                           "scripts/bench_attn_variants.py:101",
                           sweep_shape),
        # no pallas_call: H and I are the XLA ops of the JAX
        # int8_dynamic_matmul, at the int8 loop's forward (B=8, flip)
        "quantize_rows": ("isegprobe_torch/csrc/quant.cu",
                          "isegprobe_tpu/ops/quant.py:44",
                          [2 * TRAINED_BATCH * 1025, 384]),
        "int8_gemm": ("isegprobe_torch/csrc/quant.cu",
                      "isegprobe_tpu/ops/quant.py:44",
                      [2 * TRAINED_BATCH * 1025, 384, 1152]),
        # no pallas_call: B's backward is the VJP the JAX custom_vjp of
        # _ln_pallas takes (_ln_pallas_ad_bwd: jax.vjp of _ln_jnp), at the
        # flagship's train step (dx alone)
        "layernorm_bwd": ("isegprobe_torch/csrc/layernorm.cu",
                          "isegprobe_tpu/ops/layernorm.py:96",
                          [TRAIN_BATCH, (TRAIN_CROP // 14) ** 2 + 1, 384])}
    # the kernels whose source instantiates the shared flash core
    on_core = ("mha_qkv", "mha", "mha_qkv_nodiv", "mha_qkv_merged")
    paths = {"host_protocol": launches, "device_loop": loop_launches,
             "flagship_bf16_forward": expected(
                 **noc["bf16_forward"]["launches_per_forward"]),
             "attn_variant_sweep": sweep_launches}
    paths.update(trained["path_launches"])
    paths.update(training["path_launches"])
    paths.update(others["path_launches"])
    paths.update(ritm["path_launches"])
    paths.update(family_training["path_launches"])
    paths.update(bf16_training["path_launches"])
    paths.update(data["path_launches"])
    paths.update(brs_res["path_launches"])
    paths.update(converted["path_launches"])
    paths.update(outputs["path_launches"])
    paths.update(int8["path_launches"])
    paths.update(demo_parallel["path_launches"])
    paths.update(extended["path_launches"])
    for fam in families.values():
        paths.update(fam["path_launches"])
    # B's backward counts beside B's forward, on the paths that train
    # through it or differentiate an objective (BRS)
    bwd_paths = {}
    for phase in (training, family_training, bf16_training, brs_res):
        bwd_paths.update(phase["backward_launches"])
    kernels = []
    timing_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")

    def timed_check(name, shape, dtype):
        return next((c for c in checks if c["kernel"] == name
                     and c["dtype"] == dtype and c["shape"] == shape
                     and c.get("expdt", "float32") == "float32"
                     and "plain_ms" in c), None)

    for name, (src, replaces, shape) in sources.items():
        # I writes bf16 on every path; its f32 output is checked elsewhere
        c = timed_check(name, shape, "float32") or timed_check(
            name, shape, "bfloat16")
        by_path = (dict(bwd_paths) if name == "layernorm_bwd" else
                   {p: counts[name] for p, counts in paths.items()})
        if not any(by_path.values()):
            fail(f"kernel {name} was launched on no main path: {by_path}")
        entry = {"name": name, "route": "cuda", "source": src,
                 **({"core": "isegprobe_torch/csrc/flash_core.cuh"}
                    if name in on_core else {}),
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 **{k: c[k] for k in timing_keys}, "shape": shape}
        c16 = timed_check(name, shape, "bfloat16")
        if c16 is not None and c16 is not c:
            entry["bfloat16"] = {k: c16[k] for k in timing_keys}
            if "plan" in c16:
                entry["bfloat16"]["plan"] = c16["plan"]
        for key in ("tile", "plan"):
            if key in c:
                entry[key] = c[key]
        # under autograd (training): forward + backward beside the plain
        # version's (and SDPA's, for D), at each train step shape
        autograd = [
            {k: g[k] for k in ("shape", "dtype", "fwd_bwd_ms",
                               "plain_fwd_bwd_ms", "library_fwd_bwd_ms",
                               "bound_ms", "bound_by", "fwd_bwd_peak_mb",
                               "plain_fwd_bwd_peak_mb",
                               "library_fwd_bwd_peak_mb", "max_abs_err",
                               "grad_rel_err") if k in g}
            for g in (training["autograd"] + family_training["autograd"]
                      + bf16_training["autograd"] + brs_res["autograd"])
            if g["kernel"] == name]
        if autograd:
            entry["autograd"] = autograd
        if name == "layernorm_bwd":
            # every shape it was checked at alone, graph-timed beside its
            # bound and aten.native_layer_norm_backward
            entry["by_case"] = [
                {k: c.get(k) for k in (
                    "shape", "dtype", "real", "needs", "launches", "ms",
                    "bound_ms", "plain_ms", "library_ms", "fwd_ms",
                    "fwd_bwd_ms", "fwd_bwd_bound_ms", "library_fwd_bwd_ms",
                    "grad_rel_err_vs_plain", "affine_bitwise_repeat")}
                for g in (training["autograd"] + family_training["autograd"]
                          + bf16_training["autograd"] + brs_res["autograd"])
                for c in g.get("backward", [])]
            entry["replaces_kind"] = ("no pallas_call: jax.vjp of _ln_jnp "
                                      "(XLA)")
        # the other backbones' shapes (phase 11d)
        family_shapes = [
            {"shape": o["shape"], "dtype": o["dtype"],
             **({"heads": o["heads"]} if "heads" in o else {}),
             **({"eps": o["eps"]} if "eps" in o else {}),
             **{k: o[k] for k in timing_keys}}
            for o in others["checks"] if o["kernel"] == name]
        if family_shapes:
            entry["other_backbone_shapes"] = family_shapes
        # the adaptive loop's shapes (phase 11e)
        adaptive_shapes = [
            {"shape": o["shape"], "dtype": o["dtype"],
             **{k: o[k] for k in timing_keys}}
            for o in ritm["checks"] if o["kernel"] == name]
        if adaptive_shapes:
            entry["adaptive_shapes"] = adaptive_shapes
        # published weights' shapes (phase 11j): D at LoftUp's padded
        # dh 128, B over the padded layout's real channels
        converted_shapes = [
            {"shape": o["shape"], "dtype": o["dtype"],
             **({"real": o["real"]} if "real" in o else {}),
             **{k: o[k] for k in timing_keys}}
            for o in converted["checks"] if o["kernel"] == name]
        if converted_shapes:
            entry["converted_weights_shapes"] = converted_shapes
        # int8 serving's shapes (phase 11l), with the yardsticks
        int8_shapes = [
            {"shape": o["shape"], "dtype": o["dtype"], "what": o["what"],
             **{k: o[k] for k in timing_keys},
             **{k: o[k] for k in ("linear_bf16_ms", "linear_bf16_bound_ms",
                                  "bias_after_cast") if k in o}}
            for o in int8["checks"] if o["kernel"] == name]
        if int8_shapes:
            entry["int8_shapes"] = int8_shapes
            entry["replaces_kind"] = ("no pallas_call: the XLA ops of "
                                      "int8_dynamic_matmul")
        if name == "jbu_filter":
            entry.update(tile=jbu_config, ptxas=jbu_ptxas)
        if name == "edt_row_envelope":
            entry.update(layout=edt_config, ptxas=edt_ptxas, by_input={
                e["input"]: {k: e[k] for k in ("ms", "plain_ms", "bound_ms")}
                for e in checks if e["kernel"] == name
                and e["shape"] == shape})
        kernels.append(entry)
    results["kernels"] = kernels
    done("13-14 sweep, kernels line")
    results["seconds"] = time.time() - t_start
    results["phase_seconds"] = phase_s
    print("phase_seconds", json.dumps(phase_s))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"chip_smoke finished in {results['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
