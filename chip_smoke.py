#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of PDA-SSD (``pdanet_tpu_torch``) on one
NVIDIA GPU and check it.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

or with ``--parent DIR`` to time another checkout's FPS, ball query,
float32 attention (forward and backward), rotated self-IoU, NMS walk and
eager b1 request beside this tree's (phases 3, 4 and 6), or with ``--sweep`` to time FPS, the ball query and the float32
attention in the launch shapes their defaults were chosen from (phases
1-2, then ``sweep``).

Phases, each of which raises on failure:

1. Preconditions: a CUDA device, its name and power limit from nvidia-smi,
   TF32 off for the float32 comparisons.
2. Build the hand-written kernels (``pdanet_tpu_torch/csrc``), one nvcc
   per source, all started together; print each kernel's registers,
   shared memory and spills (``-Xptxas -v``; the 12 instantiations of the
   float32 / float64 attention kernels and the IoU and NMS kernels must
   not spill) and the resident
   warps per SM of the bfloat16 attention kernels at the main-path shapes.
3. Each kernel against its plain PyTorch version on the card, at the
   KITTI main-path shapes, B = 1 and 2, on LiDAR-like x-sorted clouds:
   FPS, ball query and NMS equal; attention within 2e-5 (float32, SIMT
   kernel) and 5e-2 (bfloat16, tensor-core kernel), at the main-path
   shapes and off the path (K 64 / hd 128, K 8 / hd 32, K 40 / hd 80,
   K 1 / hd 16); IoU within rtol 2e-4 / atol 2e-5 with a diagonal of 1.
   ``torch.nn.functional.scaled_dot_product_attention`` (SDPA), the one
   PyTorch call that computes the attention, is held to the same
   tolerances and timed beside the kernel as its yardstick, in turns.
   Times are medians of 20 runs (50 for a kernel timed beside SDPA) under
   CUDA events with the same inputs each run (L2-warm); the headline
   attention shape is also timed with the L2 flushed before each run.
   FPS and the ball query are also held equal beyond their headline
   shapes (``check_fps_ball_query``): FPS at B = 4, on ONCE's 60000 points
   (timed), at every N of FPS_SIZES (each instantiation of its kernel),
   on a shuffled cloud and on duplicated points that tie across CTA
   slices, with its time per serial step; the ball query at the SA0, SA1,
   SA2 and SA5 shapes at B = 1 and 4, ONCE SA5's three radii, a shuffled
   support, shuffled centres and points within 3 float32 ulps of each
   radius, with the share of tiles its skip proved out of reach, its
   bytes and operations bounds apart and its device time under the
   profiler.  The IoU and NMS beyond their headline shapes
   (``check_iou_nms``): the IoU at spread 12 and 3 (most pairs meet), B = 1
   K = 1024, on duplicated boxes, zero-size boxes and pairs within 1e-3 m
   of its circle skip's distance (diagonal 1 for boxes of nonzero area);
   the NMS keep mask equal at K 1, 63, 64, 65, 256, 1024 and 4096 (the
   last two on a synthetic sparse IoU), thresh 0.01, 0.1 and 0.7, valid
   all, none and random, and at K 4097, 9000 (B = 2) and 10240 (the
   walk's second instantiation, five removed words a lane), thresh 0.1
   and 0.8, random valid, with its device time per serial step.
   ``--parent DIR`` (another checkout, e.g. a ``git archive`` of the
   parent commit) times that tree's FPS, ball query, float32 attention
   forward, IoU and NMS in turns beside this tree's at each of those
   main-path shapes (the IoU and NMS also at B = 1 K = 1024), under CUDA
   events and the profiler, and holds its IoU against this tree's bit for
   bit (the differing pairs printed).
4. Serve: PDA-SSD at the full width of tools/cfgs/kitti_models/PDA-SSD.yaml
   (bfloat16 compute as shipped, seeded random weights) answers three
   one-frame requests and one two-frame request through
   ``serving.make_predict_fn``; every kernel of the path must have
   launched, the attention on the bfloat16 tensor-core kernel.  With
   ``--parent``, that tree's closure on the same weights answers the first
   request (its detections printed beside this tree's), and the two
   closures' latency and host enqueue time are timed in turns
   (``request_ms``, four turns each), and the host time of one call of
   each serving wrapper of both trees (``vs_parent_dispatch``, in
   inference and in grad mode).
5. One frame in float32 on the card (kernels) against the same weights on
   the CPU (plain versions, the labelled reference): equal sampling and
   ball-query indices, centre features within 1e-3, logits within 2e-3,
   equal detection counts.  Then a report, not a gate: phase 4's bfloat16
   closure on the same frame against the float32 card detections, paired
   by mutual nearest box centre with the same label.
6. The attention backward kernels against the plain backward on the card,
   at the B = 4 training shapes of SA1 (hd 64) and SA2 (hd 128), K 16 and
   32, float32 (SIMT) and bfloat16 (tensor cores), with SDPA's autograd
   backward timed beside them, and off the path at K 64 / hd 128, K 8 /
   hd 32, K 40 / hd 80 and K 1 / hd 16: max abs error <= 2e-5 in float32,
   <= 5e-2 of the largest |gradient| in bfloat16 (and <= 1e-12 in float64
   at SA1 K 32).  The attention op's gradient on the card against the plain
   backward in float32 and in bfloat16, each through its kernel, and
   ``torch.autograd.gradcheck`` of it on the card in float64.  With
   ``--parent``, that tree's float32 backward timed in turns beside this
   tree's at the B = 4 shapes.
7. Train: PDA-SSD at full width, bfloat16 train compute as shipped, takes
   5 steps of the yaml's adam_onecycle on 4 LiDAR-like frames with gt
   boxes of the three classes on their clusters, through
   ``train.make_train_step``; finite loss and gradients at every step;
   FPS, ball query and both bfloat16 attention kernels launched; then 3
   float32 steps, through the SIMT attention kernels.  Then one step at
   B = 1 on the card against the CPU (plain versions) from the same
   weights.  In float32: equal D-FPS and ball-query indices (ctr-aware
   picks equal up to swaps of scores within 1e-5), loss within 1e-4
   relative, BatchNorm running statistics within 1e-5 (of max(1, |stat|)),
   every gradient leaf within 1e-1 of its scale (its largest |gradient|,
   floored at 1e-3 of the largest leaf's: one float32 step is chaotic at
   the 1e-3 level on either device, see ``compare_train``).  In float64,
   with the indices fed: loss within 1e-10, every gradient leaf within
   1e-3 of its scale (floored at 1e-6 of the largest leaf's), statistics
   within 1e-5.  And the max-pool gradient goes to
   the first of tied slots on the card.
8. ONCE (tools/cfgs/once_models/PDA-SSD.yaml) at full width, seeded
   random weights, through the port's data pipeline: a synthetic ONCE
   root (6 train and 2 val frames of 70000 roof-LiDAR-like points, 20-40
   boxes of the five classes) in a temporary directory,
   ``create_once_infos`` and the gt database, the loader with the yaml's
   augmentor and processors (60000 points sampled); 5 bfloat16 and 2
   float32 train steps at B = 2 (ver2 vote loss) with step times, device
   busy time and peak memory; ``eval_one_epoch`` on the val split at B = 1
   (every key of the ONCE result dict, finite); a b1 request's latency and
   device split; the SA0 ball query at 60000 support points and 16384
   centres equal to its plain version, with its device time and tile
   skip; one float64 train step on the card against the CPU with every
   index fed (loss within 1e-9 relative, gradients within 1e-3 of each
   leaf's scale, statistics within 1e-5).  Every kernel must launch on
   the ONCE path.
9. KITTI through the CLIs: the shipped tools/cfgs/kitti_models/PDA-SSD.yaml
   at full width (16384 sampled points, bfloat16 as shipped), run as a
   user runs it from tools/ (``cfgs`` linked into a temporary working
   directory), on a synthetic KITTI root the script writes there (32
   train and 4 val frames of 120000 LiDAR-like 360-degree points, 10-20
   Car / Pedestrian / Cyclist boxes a frame with returns on them, the
   calib, road-plane and label files of ``tests/kitti_fixture.py``'s form,
   black 1242 x 375 PNGs written by ``utils/png.encode_png``);
   ``create_kitti_infos`` and the gt database; the loader alone over one epoch (host ms per
   batch); ``python -m pdanet_tpu_torch.tools.train`` in process for one
   epoch at B = 4 with the evaluation of its checkpoint (losses finite,
   ms per iteration and the wait for the loader from its metrics);
   ``python -m pdanet_tpu_torch.tools.test`` on the checkpoint at B = 1
   with ``--infer_time`` (``result.pkl`` holds every val frame with the
   KITTI keys; the official evaluation's result dict, finite, and its
   seconds); the fps, ball-query, bfloat16 attention and attention-
   backward, IoU and NMS kernels must launch on this path.  Then the same
   B = 4 bfloat16 steps on the loader's batches with the loader idle, the
   device split of one, and one val
   frame in float32 through the test CLI on the card and on the CPU (at
   the yaml's SCORE_THRESH, cut tenfold on the card until the frame has a
   detection): equal detection counts, at least one, every detection
   paired by mutual nearest centre within 1e-3 m.

10. Export and serve: the shipped KITTI yaml at b1 and b2 and the ONCE
   yaml at b1 (full width, bfloat16 as shipped, seeded random weights)
   traced by ``serving.export_serving`` (``torch.export``, every kernel a
   ``torch.library`` op) and saved with their sidecars (export seconds and
   MB printed); the KITTI b1 program's request latency and host enqueue
   time beside the eager closure's (the graph that was saved, run in this
   process; medians of 20 after warm-up, host clock ending in a
   synchronise, two turns) with the device busy time and the operators
   each dispatches a request, a report.  In the tail: each program reloaded
   in a fresh ``python3`` that imports torch and the port's ops and
   serving modules only, answering 3 LiDAR-like requests: detection
   counts and labels equal to the eager closure's, boxes and scores within
   1e-5, and FPS, the ball query, the bfloat16 attention, the IoU and the
   NMS launched inside the program.  Beside that process, ``python -m
   pdanet_tpu_torch.tools.serve`` over 5 velodyne files (4 of 120000
   points, one of 9000 that wraps) on the KITTI b1 program: one JSON line
   a file, equal to the closure's on the same preprocessed cloud.
11. Data parallel.  (a) Phase 9's root and yaml through the port's
   ``tools/scripts/dist_train.sh`` (torchrun, ``--launcher pytorch``,
   world 1: NCCL refuses two ranks on one GPU; one epoch at B = 4 with
   the evaluation) and ``dist_test.sh`` on its checkpoint: the process
   group's backend NCCL (from the rank-0 log), one checkpoint, finite
   losses, both merged evaluations holding every val frame in order; the
   NCCL version and the iteration times beside phase 9's (both scripts in
   the tail); in a fresh process, the B = 4 bfloat16 step with the loader
   idle in three turns -- no process group, NCCL's world 1, none -- with a
   device split of each mode.  (b) Two ranks sharing the card through Gloo (each a
   fresh ``python3``), one LiDAR-like frame each, against one process at
   B = 2 on the same frames: a float32 data-parallel step (the ranks'
   state bit-equal after it), a float64 step with the one process's
   sampling and ball-query picks fed (loss within 1e-9 relative; every
   gradient leaf within 1e-9 of its scale, floored at 1e-3 of the largest
   leaf's, or within 10 times the one process's own difference with its
   frames in reverse order; BatchNorm statistics within 1e-9; parameters
   after the update within 1e-9 of their scale plus the learning rate
   times the gradient's error over Adam's eps; the ranks bit-equal), and
   each frame through the serving closure; all six ops launched in the
   one process and in each rank.
12. PointPillar: tools/cfgs/kitti_models/pointpillar.yaml at full width,
   nothing cut (432 x 496 pillars of 0.16 m, 40000 test and 16000 train
   pillars of 32 points, 64 BEV channels, 321408 anchors a frame), seeded
   weights, float32 (the yaml sets no compute dtype), cuDNN's TF32 off as
   phase 1 leaves it.  (a) Serving: 120000-point LiDAR-like KITTI frames
   (phase 9's generator) through the yaml's processors and the host
   voxelizer at the test budget; three b1 requests and one b2 through
   ``serving.make_predict_fn``, the IoU and NMS kernels launched at K =
   NMS_PRE_MAXSIZE = 4096; a b1 request's device split (its latency with
   TF32 on beside it in phase 13 and SECOND-IoU's); one frame on the card
   against the CPU (plain versions): logits within 2e-3, boxes within
   1e-3 of max(1, |value|) with headings compared modulo the direction
   bins' period (an anchor may turn by pi only where its two bin logits,
   or its raw heading and the period's fold, tie within 1e-4), and the
   detections paired box for box by
   mutual nearest centre (equal counts, centres within 1e-3 m, scores
   within 1e-4).  (b)
   Training: 2 float32 steps at B = 4 on the train budget (step time,
   peak memory, device split; no self-IoU runs there), then one float64 step at B = 1 on the card
   against the CPU (loss within 1e-10 relative, gradient leaves within
   1e-8 of their scale, statistics within 1e-10).  (c) The yaml through
   the train CLI (one epoch of the first 8 of phase 9's 32 train frames at
   B = 4, augmentor and all) and the test CLI with the official KITTI
   evaluation; ``dist_train.sh`` at world 1 over NCCL (in the tail).
   (d) The b1 program through
   ``serving.export_serving`` and ``save_serving``, reloaded by
   ``load_serving`` in a fresh process (torch and the port's ops and
   serving modules only), bit-equal to the eager closure.  (e) The
   self-IoU (rtol 2e-4 / atol 2e-5 of its plain version, run 1024 rows at
   a time) and the NMS walk (equal) at K 4096 on frame 0's candidates,
   timed in turns with their plain versions under CUDA events, with their
   device times and bounds.
13. SECOND: tools/cfgs/kitti_models/second.yaml at full width, nothing
   cut (a 0.05 x 0.05 x 0.1 m grid of 1408 x 1600 x 40 cells, 40000 test
   and 16000 train voxels of 5 points, MeanVFE, the gather-matmul
   ``SparseVoxelBackBone8x`` with ``NUM_FILTERS [16, 16, 32, 64, 64]`` and
   128 output features, a 2 x 128 = 256-channel BEV map of 200 x 176,
   ``LAYER_NUMS [5, 5]``, 211200 anchors a frame), seeded weights,
   float32, TF32 off: (a)-(e) as phase 12, on the same root and frames, at
   less depth (3 latency repeats a turn, 3 train steps, no device split of
   a step), and in (a) the
   active sites of every level of the sparse backbone in each request, which levels filled their budget, and the b1 frame's
   coordinates and neighbour tables of every level on the card equal to
   the CPU's.
14. Voxel-RCNN: tools/cfgs/kitti_models/voxel_rcnn_car.yaml at full
   width, nothing cut (phase 13's grid, voxels and sparse backbone, a
   256-channel BEV map of 200 x 176 with ``[64, 128]`` filters, 70400
   anchors; the proposal layer at NMS_PRE_MAXSIZE 2048 to serve and 9000
   to train, 100 / 512 RoIs kept, 128 sampled a frame to train; the RoI
   grid pool of 216 points a RoI over x_conv2-x_conv4, 9 x 9 x 9 windows,
   16 samples; the 256-wide FC stacks), seeded weights with the box conv
   scaled by 0.01 (so that boxes stay near their anchors), float32, TF32
   off.  (a) Serving as phase 13, the IoU and NMS kernels launched at K
   2048 (the proposals, some suppressed) and K 100 (the refined boxes);
   the RoIs kept and the grid points with an empty and with a full window
   on each level (some full); one frame on the card against the CPU: the
   first stage's logits within 2e-3, then, on the card's own inputs, the
   proposal layer's keep mask and RoIs equal, every level's voxel-query
   table, hits and empty windows equal, ``rcnn_cls`` / ``rcnn_reg`` within
   2e-3 and the detections paired box for box; the voxel query and pool
   of RoIs on the frame's gt boxes equal (pooled features within 2e-3),
   full windows on every level there.  (b) 2 float32 steps at B = 2 on
   the train budget, 2 gt boxes a frame planted on its proposals, the IoU
   and NMS kernels launched at K 9000 and suppressing, foreground RoIs in
   the first step's sample, then one float64 step at B = 1 on the card
   against the CPU (loss within 1e-10 relative, gradient leaves within
   1e-8 of their scale), the same per-frame draws on both, the CPU's
   proposal layer fed the plain IoU of the card's candidates (computed on
   the card) and its keep mask equal to the kernel's, foreground RoIs in
   the sample.  (c) The
   CLIs as phase 12 at B = 2, with the first-stage ``recall_roi_*``
   beside ``recall_rcnn_*``.  (d) Export as phase 12.  (e) The self-IoU
   and the NMS walk on frame 0's proposal candidates at K 9000 (the
   TRAIN proposal layer) and K 2048 (TEST), against their plain versions,
   timed in turns, with device times and bounds.
15. The dense voxel backbone, SECOND-IoU and the multi-head:
   tools/cfgs/kitti_models/second_iou.yaml at full width (the dense
   ``VoxelBackBone8x`` over a grid of 1408 x 1600 x 40 cells plus the top
   plane, 40000 test / 16000 train voxels of 5 points, ``NUM_FILTERS [16,
   16, 32, 64, 64]`` -> 128, a 256-channel BEV map of 200 x 176 into 512,
   211200 anchors; proposals at K 1024 -> 100 RoIs to serve and K 9000 ->
   512 -> 128 sampled a frame to train; a 7 x 7 BEV pool over 512
   channels, 256-wide FC stacks), seeded weights with the box conv scaled
   by 0.01, float32, TF32 off, on phase 9's frames.  (a) As phase 14, with
   each request's peak memory, the dense ladder alone under CUDA events
   beside its 3-D convolutions' operations and bound, its device split by
   full kernel name; one frame card vs CPU on ``DENSE_CROP`` (first-stage
   maps within 2e-3), then at full width on the card's inputs: the
   proposal keep mask at K 1024 and the RoIs equal, ``rcnn_iou`` within
   2e-3, the detections paired box for box.  (b) 2 float32 steps at B = 1
   (the yaml's 4 cut), the IoU and NMS at K 9000 suppressing, foreground
   RoIs in the first sample, peak memory; one float64 step on the crop on
   the card against the CPU, the CPU fed the card's plain self-IoU and
   3-D RoI IoUs (loss within 1e-10 relative, gradient leaves within 1e-8
   of their scale).  (c) The train CLI (one epoch of a root of its own,
   ``DENSE_CLI_SPLITS``, at B = 1), the test CLI and the export CLI on its
   checkpoint with ``--verify``.  (d) Export as phase 12.  (e) The IoU and
   NMS on frame 0's candidates at K 9000 and 1024 and on its scored RoIs
   at K 100.  Then tools/cfgs/kitti_models/second_multihead.yaml at full
   width (the same ladder, three separate heads of one class, the
   per-class NMS at K 4096), seeded weights, at less depth: (a) one b1
   request, the three per-class keep masks on the card's inputs equal to
   the CPU's walk on the plain IoU of the card's candidates, the
   detections paired; (b) two steps and the float64 step on the crop; (d);
   (e) each class's candidates at K 4096.
16. CenterPoint and the zoo's point augmentors:
   tools/cfgs/kitti_models/centerpoint.yaml at full width (phase 13's grid,
   voxels and ``SparseVoxelResBackBone8x`` with ``ACTIVE_BUDGETS [16384,
   16384, 16384, 8192]``, a 256-channel BEV map of 200 x 176 into the
   anchor-free head's 400 x 352 maps, three classes in one head, the top
   500 candidates into one NMS at K 500, thresh 0.7), seeded weights (the
   heatmap's output bias -2.19; the dim, centre and heading sine output
   convs scaled, ``seed_center_boxes``, so that neighbouring candidates
   overlap), float32, TF32 off.  (a) Serving as phase 13 (three b1
   requests and one b2, busy time, peak memory), some candidates
   suppressed; one frame on the card against the CPU: the head's maps
   within 1e-5 of the CPU's own forward, then on the card's maps the
   top-K indices, the decoded candidates and the NMS keep mask equal to
   the CPU's and the detections paired box for box.  (b) 2 float32 steps
   at the yaml's B = 4, then the float64 step at B = 1 card vs CPU.  (c)
   The CLIs on phase 9's root.  (d) Export as phase
   12.  (e) The IoU and NMS on the candidates that request 0's NMS was
   given (recorded by ``RecordIoUShapes``) at K 500, some suppressed.
   Then
   tools/cfgs/kitti_models/pointpillar_newaugs.yaml and
   pointpillar_pyramid_aug.yaml through the train CLI, one epoch at B = 4
   on a root of their own (``AUG_CLI_SPLITS``), and the newaugs yaml's
   loader alone over that epoch with its DISABLE_AUG_LIST emptied (the
   shipped yaml disables both frustum dropouts and the local
   translation): for each augmentor, on how many frames it changed the
   points or the boxes.
17. PV-RCNN and PV-RCNN++: tools/cfgs/kitti_models/pv_rcnn.yaml at full
   width (SECOND's grid, voxels and sparse backbone, three classes of
   anchors; the proposal layer at K 1024 / 9000 into 100 / 512 RoIs, 128
   sampled a frame; 2048 keypoints by FPS over the 16384 sampled raw
   points; the VSA over the BEV map, the raw points and x_conv1-x_conv4
   by the ball query, sentinel rows of the levels at 1e6; a 6 x 6 x 6 RoI
   grid pooled from the keypoints by the ball query; the final NMS at K
   100), seeded weights with the box conv scaled as in phase 14, float32,
   TF32 off.  (a) Serving as phase 13; one frame on the card against the
   CPU (``pv_card_vs_cpu``): the first-stage logits within 2e-3, then on
   the card's inputs the proposals, the keypoint indices and each
   source's ball-query indices equal, each source's pooled keypoint
   features, the fused ones, the point scores and the RCNN outputs within
   1e-5 of max(1, |value|) (``PV_STAGE_TOL``; the same stages with TF32
   on, the control, must exceed it), the detections paired box for box.  (b) 2 float32
   steps at the yaml's B = 2 (gt planted on the proposals), then the
   float64 step at B = 1 card vs CPU, the CPU fed the card's FPS and
   ball-query indices (``RecordPicks``).  (c) The CLIs and
   ``dist_train.sh``.  (d) Export.  (e) FPS 16384 -> 2048 and the ball
   query at each of its six supports on request 0's own inputs, and the
   IoU and the NMS at K 9000, 1024 and 100.  Then
   tools/cfgs/kitti_models/pv_rcnn_plusplus.yaml at full width (SPC
   sampling, VectorPool over the raw points, x_conv3, x_conv4 and in the
   RoI grid pool) at less depth: one b1 request card against CPU, one
   float32 step and the float64 step, (d), and FPS on request 0's
   SPC-collapsed cloud and on the raw cloud with all but 1024 points
   collapsed onto its first point, against the plain version.

18. Part-A2 and Part-A2-free: tools/cfgs/kitti_models/PartA2.yaml at full
   width (SECOND's grid and voxels, the sparse UNetV2: the sparse ladder,
   its encoded BEV map of 256 channels, the decoder's UR blocks and inverse
   convs back to the input voxels; the intra-part head on the 16-channel
   voxel features; 211200 anchors of three classes; the proposal layer at
   K 1024 / 9000 into 100 / 512 RoIs, 128 sampled a frame; the RoI-aware
   pool of the voxels into 12 x 12 x 12 cells, four masked 3-D convs, the
   256-wide FC stacks; the final NMS at K 100), then
   tools/cfgs/kitti_models/PartA2_free.yaml (MODEL.NAME PointRCNN, which
   the port resolves to ``PartA2Free``: the sparse UNet without the BEV
   map, the intra-part head's per-voxel boxes as the proposals at K 9000
   to serve and to train, the pool of the voxel centres with
   ``DISABLE_PART``), seeded weights with the box conv (Part-A2-free: the
   point head's box layer) scaled as in phase 14, float32, TF32 off.  (a)
   Serving as phase 13; one frame on the card against the CPU
   (``parta2_card_vs_cpu``): the UNet's voxel features and the point
   head's outputs of the CPU's own first stage within
   ``PARTA2_STAGE_TOL`` of max(1, |value|), Part-A2's anchor logits
   within 2e-3; then on the card's inputs the proposals equal, the
   voxels' cells in each RoI equal but for ``PARTA2_CELL_FLIPS`` and the
   pooled grids within the gate at the cells those leave untouched, the RoI
   head's outputs on the card's pooled grids (the proposals' and the gt
   boxes') within the gate (the same stages with TF32 on, the control,
   must exceed it), the detections paired box for box.  (b) 2 float32
   steps at the yaml's B = 4 (gt planted on the proposals), then the
   float64 step at B = 1 card vs CPU on ``DENSE_CROP``.  (c) The train and
   test CLIs on a root of their own (``PARTA2_CLI_SPLITS``: 2 train and 2
   val frames); the export CLI is phase 15a's, ``dist_train.sh`` PointRCNN's
   (``VOXEL_DEPTH``).  (d)
   Export.  (e) The IoU and the NMS at K 9000, 1024 and 100 (Part-A2-free:
   9000 and 100).

19. PointRCNN and PointRCNN-IoU: tools/cfgs/kitti_models/pointrcnn.yaml at
   full width (16384 sampled points; the PointNet++ MSG backbone 16384 ->
   4096 -> 1024 -> 256 -> 64, two radii a level, widths up to 512, its FP
   decoder back to the points at 128 channels; the point-box head's
   per-point boxes of three classes proposed at K 9000 into 100 / 512
   RoIs, 128 sampled a frame; 512 points pooled a RoI, the SA stages
   [128, 32, -1] over the B * R clouds; the final NMS at K 100), seeded
   weights with the point head's box layer scaled as in phase 14, float32,
   TF32 off, on phase 9's 16384-point frames.  (a) A b1 and a b2 request;
   one frame on the card against the CPU (``pointrcnn_card_vs_cpu``): the
   backbone's FPS, ball-query and three-NN indices equal, its features
   and the point head's outputs within ``PV_STAGE_TOL`` of max(1,
   |value|); on the card's inputs the proposals equal, the RoI pool's
   memberships equal but for ``POINTRCNN_POOL_FLIPS`` and its clouds
   within the gate at the RoIs those leave untouched, the RoI head's
   indices equal and its outputs within the gate (the TF32 control must
   exceed it), the detections paired box for box.  (b) 2 float32 steps at
   the yaml's B = 2 (gt planted on the proposals), then the float64 step
   at B = 1 card vs CPU, the CPU fed the card's FPS, ball-query and
   three-NN picks.  (c) The train and test CLIs on phase 9's root,
   ``dist_train.sh`` in the tail.  (d) Export.  (e) The IoU and the NMS at
   K 9000 and 100; FPS over request 0's 100 RoI clouds of 512 points (one
   launch; the clouds also made degenerate: every third RoI empty, every
   other third cycling three points) and the RoI head's ball query,
   against their plain versions.  Then tools/cfgs/kitti_models/
   pointrcnn_iou.yaml (``CLS_SCORE_TYPE`` roi_iou, B = 3): one b1
   request, one step whose sampled RoIs' labels are the soft labels of
   their IoUs, the CLIs (at B = 2), export.

20. CaDDN: tools/cfgs/kitti_models/CaDDN.yaml at full width (375 x 1242
   images; the DDN at width 256 with 80 LID depth bins, its stride-4
   features reduced to 64 channels; the 80 x 94 x 311 x 64 frustum sampled
   into a 25 x 376 x 280 x 64 voxel grid; Conv2DCollapse to 64 BEV
   channels; the BEV backbone's [10, 10, 10] layers; 157920 anchors; the
   single-class NMS at K 4096), seeded weights, float32, TF32 off, on a
   camera root of its own beside phase 9's (``camera_root``: 4 train and 2
   val frames of phase 9's kind with textured images of 375 x 1242 and 370
   x 1224 in turn and 16-bit depth maps of their returns, written with
   zlib).  (a) A b1 and a b2 request (the two sizes padded by the collate)
   through the serving closure, the IoU and NMS kernels launched at K
   4096; the b1 latency and device split; frame 0 on the card against the
   CPU (``caddn_card_vs_cpu``): the depth logits, the voxel features, the
   BEV map and the head's maps within ``CADDN_STAGE_TOL`` of max(1,
   |value|), the TF32 control beyond it, the detections paired box for
   box.  (b) One float32 step at the yaml's B = 4 with its peak memory,
   then one float64 step on ``CADDN_CROP`` card vs CPU.  (c) The train and
   test CLIs on the camera root, ``dist_train.sh`` in the tail; the
   serving spec and the export CLI refuse the camera inputs, as the JAX
   package's serving does (no program, no serve CLI).  (e) The IoU and the
   NMS at K 4096 on frame 0's candidates.
20b. The variants the JAX package builds and no shipped yaml names
   (``VARIANTS``), each in memory from a shipped yaml at full width:
   PointPillar over ``DynamicPillarVFE``, SECOND over ``DynamicMeanVFE``
   and the dense ladder, SECOND with the ATSS assigner, Voxel-RCNN over the
   dense ladder (the dense-grid ``NeighborGridPool``).  Each serves one b1
   request, the IoU and NMS kernels launched at every K of its path; card
   vs CPU: the dynamic PointPillar's frame at full width, the dynamic
   SECOND's on ``DENSE_CROP``, Voxel-RCNN's first stage and RoI head on
   ``DENSE_CROP`` on the card's RoIs, SECOND-ATSS's targets after one
   B = 4 step (its request is SECOND's forward, phase 13's); (e) the IoU
   and the NMS on the candidates of the dynamic variants' and Voxel-RCNN's
   request.
21. The rest of the IASSD surface (``iassd_phase``; alone with
   ``--phases 21``).  The F-FPS kernel (``csrc/fps_features.cu``) equal to
   its plain version at SA1's shape (B 1 and 2, N 4096, C 67, 512 picks;
   duplicated rows; rows read from global memory at N 20000, C 300), with
   its time, the plain version's and its bound; the attention kernels at
   no_global's head widths (hd 48 and 96, K 16 and 32, float32 and
   bfloat16, forward at b1 and backward at B = 4) against the plain
   versions, timed beside SDPA.  Two variants of PDA-SSD.yaml at full
   width, built by the CLIs' ``--set`` (``IASSD_VARIANTS``), seeded
   weights, TF32 off: V1 (SA1 by FS 512 + 512, ``PDA_VARIANT: no_global``,
   ``PROPOSAL_AWARE_CBAM``, ``IOU_FC``) serves a float32 b1 and b2 request
   and V2 (SA0 by ``ds_FPS``, ``POINTFORMER_IMPL: encoder_layer``,
   ``IOU_FC``) a b1, each against the CPU with the card's picks fed (the
   CPU's own D-FPS and sector picks equal, ball-query indices equal,
   features within 1e-3, cls / box / IoU logits within 2e-3, equal
   detection counts), the F-FPS calls held to the plain version on their
   own rows; a bfloat16 b1 request of each (a report); V1's b1 program
   bit-equal to its eager closure; one float32 train step at B = 2 of each
   (``iou3d_loss_reg`` finite).  Then ``ry_fps``, the ellipsoid query, the
   dilated query and ``nms_rotated`` once each, card against CPU.
22. The reference checkpoint surface and the profiler CLI
   (``checkpoint_phase``; ``--phases 22`` runs phases 4 and 9 with it).
   (a) The shipped PDA-SSD.yaml and voxel_rcnn_car.yaml at full width,
   seeded weights (Voxel-RCNN's box conv scaled as in phase 14), written
   by ``reference_state_dict`` (the converter's inverse, no JAX) into
   reference ``.pth`` files in OpenPCDet's wrapper with
   ``num_batches_tracked`` and ``global_step`` beside (PDA-SSD in torch's
   zip format, Voxel-RCNN in the legacy one); ``python -m
   pdanet_tpu_torch.tools.ckpt_converter`` on each in a fresh process; the
   converted ``state_dict`` bit-equal to the seeded one (epoch, it and
   version carried, no optimizer state); a float32 b1 request from each
   converted checkpoint, loaded as the test CLI loads it, equal to the
   seeded model's on the same frame (counts and labels equal, boxes and
   scores within ``CONVERT_TOL``), PDA-SSD's launching FPS, the ball
   query, the attention, the IoU and the NMS; the test CLI ``--ckpt`` on
   the converted PDA-SSD over phase 9's root, in the tail.  (b) ``python
   -m pdanet_tpu_torch.tools.profiler --mode e2e --batch_size 1`` on
   PDA-SSD (in process, beside the converters): its table of families
   names each kernel of ``PROFILE_KERNELS``; its busy time beside phase
   4's closure's split on the same frame.
23. The host library (``host_library_phase``; ``--phases 23`` runs phase 9
   with it), on the host before the tail: the port's g++ library
   (``pdanet_tpu_torch/native``) at the four sites where the JAX package
   runs its own, each against its numpy plain version on the same inputs,
   host milliseconds of both.  (a) A fresh build (its seconds, the
   compiler, the loaded library's path).  (b) The voxelizer through
   pointpillar.yaml's and second.yaml's processors at both budgets on five
   120000-point ``kitti_like_frame`` frames, equal.  (c)
   ``points_in_boxes_cpu`` on those frames and their boxes, equal but for
   points within ``HOST_FACE_ULPS`` of a face (each printed).  (d) The gt
   sampler's collision test (50 sampled boxes against a frame's and each
   other), (e) ``rotate_iou_eval`` with its four criteria on the inputs
   phase 9's official evaluation passed it, both within
   ``HOST_OVERLAP_TOL``.  (f) PointPillar's b1 request from points to
   detections (processors, collate, request) with the library's voxelizer
   and the plain one in turns, the detections equal.

Depth (``VOXEL_DEPTH``; every kernel row, family and phase stays): phases
12-19 serve one b1 and one b2 request (15b, 17b and 19b one b1), take one
float32 step (19a two), and their CLIs train over 4 of phase 9's frames,
``dist_train.sh`` too in 12, 14, 17 and 19a (one model a family, and 20's
CaDDN: 13, 16, 18a, 18b and 19b do not); 15b, 17b and 18b take no float64 step (18b's point-box
head is 19a's, its RoI head 18a's), CenterPoint's runs on ``DENSE_CROP``.
Phase 8 takes no float32 frame against the CPU (its float64 step does,
with the same forward; phases 3 and 8 hold FPS and the ball query at
ONCE's shapes to their plain versions).

The script ends in a tail, run once every phase has measured, so that
nothing else runs on the card beside a measurement: three export
processes export phases 12-19's b1 programs (d) from their saved weights,
and one fresh process reloads each as it is saved and holds it bit-equal
to the eager closure's outputs on the same frame (saved in the phase),
while phase 10's fresh process and serve CLI, phase 11's
``dist_train.sh`` and ``dist_test.sh`` and the ``dist_train.sh`` runs of
phases 12, 14, 17, 19a and 20 (c, at B = 1) go, seven chains at a time.

Each phase prints its wall time.  The line before the last is
``{"kernels": [...]}``: per kernel its launches in the main-path runs
(phase 4's requests, phase 7's bfloat16 and float32 train steps, phase
8's ONCE train steps and ``eval_one_epoch``, phase 9's train and test
CLIs, phase 10's exported programs, phase 11's CLI processes, one
process and ranks, phases 12-19's requests, train steps, CLIs and
programs, and phase 22's converted requests and test CLI, each run
counted from 0), its
largest error,
and at its headline shape its time, its plain version's time, its bound
(the larger of bytes over 3.35 TB/s and operations over the peak rate of
their type, from this run's inputs) and SDPA's time where SDPA computes
the same function; then the IoU and the NMS walk again at phase 12's K
4096 (``rotated_iou_k4096``, ``nms_k4096``: phase 12's launches at that
K, (e)'s numbers) and at phase 13's (``rotated_iou_k4096_second``,
``nms_k4096_second``), and at phase 14's K 9000 and 2048
(``rotated_iou_k9000_voxel_rcnn`` ... ``nms_k2048_voxel_rcnn``, phase
14's launches at each K, ``cuda_lib.launches_by_k``), and at phase 15's
K 9000, 1024 and 100 (``rotated_iou_k9000_second_iou`` ...) and K 4096
(``rotated_iou_k4096_multihead``, ``nms_k4096_multihead``), and at phase
16's K 500 (``rotated_iou_k500_centerpoint``, ``nms_k500_centerpoint``),
and at phase 17's K 9000, 1024 and 100 (``rotated_iou_k9000_pv_rcnn`` ...
``nms_k100_pv_rcnn``), with PV-RCNN's FPS (``fps_k2048_pv_rcnn``: the
phase's FPS launches) and ball query at each source
(``ball_query_raw_points_pv_rcnn``, ``ball_query_x_conv1_pv_rcnn`` ...
``ball_query_roi_grid_pool_pv_rcnn``: the phase's ball-query launches
at that site, ``cuda_lib.launches_by_site``) and PV-RCNN++'s FPS on the collapsed cloud
(``fps_spc_pv_rcnn_pp``), and at phase 18's K 9000, 1024 and 100
(``rotated_iou_k9000_part_a2`` ... ``nms_k100_part_a2_free``), and at
phase 19's K 9000 and 100 (``rotated_iou_k9000_pointrcnn`` ...) with the
RoI head's FPS (``fps_k512_roi_pointrcnn``: the phase's FPS launches on
512-point clouds, ``fps_n512`` of ``cuda_lib.launches_by_k``) and ball
query (``ball_query_roi_pointrcnn``), and at phase 20's K 4096
(``rotated_iou_k4096_caddn``, ``nms_k4096_caddn``) and phase 20b's
(``rotated_iou_k4096_pointpillar_dynamic``, ``..._second_dynamic``,
``rotated_iou_k2048_voxel_rcnn_dense``, ``..._k100_voxel_rcnn_dense``).
And F-FPS's row (``fps_features``: phase 21's launches, its numbers at
SA1's shape; it replaces no Pallas kernel, the JAX package runs F-FPS in
XLA).  The line before it gives the script's seconds.
The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import json
import os
import pickle
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np

from pdanet_tpu_torch.tools.profiler import device_split, lidar_like_cloud

ROOT = Path(__file__).resolve().parent
YAML = ROOT / "tools" / "cfgs" / "kitti_models" / "PDA-SSD.yaml"
N_POINTS = 16384

KERNELS = {  # name: (source, TPU kernel it replaces)
    "fps": ("pdanet_tpu_torch/csrc/fps.cu", "pdanet_tpu/ops/pallas/fps.py:365"),
    "ball_query": ("pdanet_tpu_torch/csrc/ball_query.cu",
                   "pdanet_tpu/ops/pallas/ball_query.py:306"),
    "neighbor_attention": ("pdanet_tpu_torch/csrc/neighbor_attention.cu",
                           "pdanet_tpu/ops/pallas/attention.py:201"),
    "neighbor_attention_bf16": ("pdanet_tpu_torch/csrc/neighbor_attention_mma.cu",
                                "pdanet_tpu/ops/pallas/attention.py:201"),
    "neighbor_attention_bwd": ("pdanet_tpu_torch/csrc/neighbor_attention_bwd.cu",
                               "pdanet_tpu/ops/pallas/attention.py:256"),
    "neighbor_attention_bwd_bf16": ("pdanet_tpu_torch/csrc/neighbor_attention_bwd_mma.cu",
                                    "pdanet_tpu/ops/pallas/attention.py:256"),
    "rotated_iou": ("pdanet_tpu_torch/csrc/rotated_iou.cu",
                    "pdanet_tpu/ops/pallas/rotated_iou.py:244"),
    "nms": ("pdanet_tpu_torch/csrc/nms.cu", "pdanet_tpu/ops/pallas/nms.py:70"),
}
# F-FPS: a kernel of the port where the JAX package runs XLA (phase 21)
FFPS_KERNEL = ("pdanet_tpu_torch/csrc/fps_features.cu", "pdanet_tpu/ops/sampling.py:108")
# the kernels each main-path run must launch
SERVE_KERNELS = ("fps", "ball_query", "neighbor_attention_bf16", "rotated_iou", "nms")
TRAIN_KERNELS = {"bf16": ("fps", "ball_query", "neighbor_attention_bf16",
                          "neighbor_attention_bwd_bf16"),
                 "f32": ("fps", "ball_query", "neighbor_attention", "neighbor_attention_bwd")}

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# peak rate of their type
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # bfloat16 on the tensor cores
# float32 operations of one pair of boxes whose circumscribed circles meet,
# counted from overlap() in csrc/rotated_iou.cu: 16 edge pairs of 117, 8
# containment tests of 14, 24 atan2 of ~22, the sort's 23 compares at the
# least and the fan's 23 steps of 6 (2733, rounded down)
IOU_PAIR_OPS = 2700
ATTN_SHAPES = (("SA1", 1024, 64), ("SA2", 512, 128))  # label, centres per frame, hd; H 4
ATTN_OFF_PATH = ((64, 128), (8, 32), (40, 80), (1, 16))  # (K, hd)
# repeats of a plain version's time in phase 3 (the plain FPS takes ~0.5 s a
# call; cut from 20, then 5, to keep the script inside its limit)
PLAIN_REPS = 3


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def lidar_like_batch(seed, B, N, mean_size, M=16):
    """A training batch: ``lidar_like_cloud`` frames and gt boxes (B, M, 8)
    on their 12 clusters, classes Car, Pedestrian, Cyclist in turn with the
    yaml's mean sizes, random headings; the last M - 12 rows are zero
    padding.  Every class holds points of every frame."""
    pts, centers = lidar_like_cloud(seed, B, N, with_centers=True)
    rs = np.random.RandomState(seed + 1)
    gt = np.zeros((B, M, 8), np.float32)
    for j, c in enumerate(centers):
        cls = j % 3
        gt[:, j, 0:3] = c
        gt[:, j, 3:6] = mean_size[cls]
        gt[:, j, 6] = rs.uniform(-np.pi, np.pi)
        gt[:, j, 7] = cls + 1
    for b in range(B):
        d = pts[b, :, None, :3] - gt[b, None, :12, 0:3]
        cosa, sina = np.cos(gt[b, :12, 6]), np.sin(gt[b, :12, 6])
        lx = d[..., 0] * cosa + d[..., 1] * sina
        ly = -d[..., 0] * sina + d[..., 1] * cosa
        inside = ((np.abs(lx) < gt[b, :12, 3] / 2) & (np.abs(ly) < gt[b, :12, 4] / 2)
                  & (np.abs(d[..., 2]) <= gt[b, :12, 5] / 2))
        for cls in range(3):
            n_in = int(inside[:, cls::3].sum())
            require(n_in > 0, f"frame {b}: no point in a box of class {cls + 1}")
    return pts, gt


def random_boxes(seed, B, K, spread=12.0):
    rs = np.random.RandomState(seed)
    b = np.zeros((B, K, 7), np.float32)
    b[..., 0:2] = rs.uniform(-spread, spread, (B, K, 2))
    b[..., 2] = rs.uniform(-1.5, 0.5, (B, K))
    b[..., 3:5] = rs.uniform(0.5, 4.5, (B, K, 2))
    b[..., 5] = rs.uniform(1.0, 2.0, (B, K))
    b[..., 6] = rs.uniform(-np.pi, np.pi, (B, K))
    return b


_flush = None


def cuda_ms(fn, reps=20, warmup=2, cold=False):
    """Median milliseconds of ``fn`` under CUDA events; with ``cold`` the
    L2 cache is flushed (a 128 MB buffer written) before each run,
    outside the events."""
    import torch

    global _flush
    if cold and _flush is None:
        _flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cold:
            _flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def in_turns(kern_fn, lib_fn, cold=False, reps=50):
    """Kernel and library call timed in turns (kernel, library, library,
    kernel), medians of ``reps`` after 5 warm-up runs; each is the mean of
    its two medians."""
    def ms(fn):
        return cuda_ms(fn, reps=reps, warmup=5, cold=cold)

    k1, l1 = ms(kern_fn), ms(lib_fn)
    l2, k2 = ms(lib_fn), ms(kern_fn)
    return (k1 + k2) / 2, (l1 + l2) / 2


def bound(n_bytes, n_ops, ops_per_s):
    """(milliseconds, "bytes" or "operations"): the least time the card
    could take, the larger of the two."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound(R, K, H, hd, dtype, bwd=False):
    """Forward: read q, k, v, write o; 4 K flops per element of one
    tensor (S and P v, 2 K^2 hd each per centre and head).  Backward: read
    q, k, v, dO, write dq, dk, dv; five such products."""
    import torch

    elems = R * H * hd
    n_tensors, n_products = (7, 5) if bwd else (4, 2)
    rate = BF16_TC_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    return bound(n_tensors * elems * torch.finfo(dtype).bits // 8,
                 2 * n_products * K * elems, rate)


def sdpa_heads(t, K, H, hd):  # (R, H*hd) -> the (C, H, K, hd) view SDPA takes
    return t.view(t.shape[0] // K, K, H, hd).transpose(1, 2)


def sdpa_forward(q, k, v, K, H, hd):
    """The library call timed beside the forward kernel: SDPA on the (C,
    H, K, hd) views of the flat tensors, default scale 1/sqrt(hd), no mask.
    Returns the call and a function giving its result in the flat layout."""
    import torch
    import torch.nn.functional as F

    views = [sdpa_heads(t, K, H, hd) for t in (q, k, v)]

    def call():
        with torch.inference_mode():
            return F.scaled_dot_product_attention(*views)

    return call, lambda: call().transpose(1, 2).reshape(q.shape)


def sdpa_backward(q, k, v, do, K, H, hd):
    """The library call timed beside the backward kernel: autograd's
    backward of SDPA, on a graph built once.  Returns the call, which
    gives (dq, dk, dv) in the flat layout."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*(sdpa_heads(t, K, H, hd) for t in leaves))
    do4 = sdpa_heads(do, K, H, hd)
    return lambda: torch.autograd.grad(o, leaves, do4, retain_graph=True)


def kernel_names(fn):
    """The device kernels one run of ``fn`` launches, by summed time."""
    split = device_split(fn)
    return "; ".join(name for name, _ in split[2]) if split else "(no profiler trace)"


def print_split(what, split):
    if split is None:
        print(f"{what}: the profiler saw no device activity")
        return
    n, busy, top, own = split
    print(f"{what}: {n} device kernels and memsets, busy {busy:.3f} ms; largest: "
          + ", ".join(f"{name} {ms:.3f} ms" for name, ms in top) + "; the port's kernels: "
          + ", ".join(f"{name} {ms:.3f} ms ({k})" for name, (ms, k) in sorted(own.items())))


def grad_err(got, want, dtype):
    """Backward error as the checks state it: max abs in float32 and
    float64, max abs over the largest |gradient| of each tensor in
    bfloat16."""
    import torch

    errs = []
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs().max().item()
        top = w.double().abs().max().item()
        # a gradient that is exactly 0 (dq and dk at K 1) is held absolutely
        errs.append(diff / top if dtype == torch.bfloat16 and top > 0 else diff)
    return max(errs)


def ball_query_work(radii, ks, sup, ctr):
    """What the ball query must scan on these inputs, summed over centres,
    as (points a first-K scan visits: up to the K-th hit of the radius
    that fills last, or all N where a ball does not fill; those of them in
    128-point tiles whose bounding box the exact box test leaves within
    reach of the centre).  Every hit lies in such a tile, so the second
    count is the work of a first-K scan that skips what is provably out of
    reach."""
    import torch

    B, N, _ = sup.shape
    d2 = ((ctr[:, :, None, :] - sup[:, None, :, :]) ** 2).sum(-1)  # (B, M, N)
    need = torch.zeros(d2.shape[:2], dtype=torch.int64, device=d2.device)
    for radius, K in zip(radii, ks):
        hits = (d2 < radius * radius).cumsum(-1)
        kth = torch.argmax((hits >= K).to(torch.uint8), dim=-1) + 1
        need = torch.maximum(need, torch.where(hits[..., -1] >= K, kth, N))
    del d2
    n_tiles = -(-N // 128)
    pad = n_tiles * 128 - N
    lo = torch.nn.functional.pad(sup, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(sup, (0, 0, 0, pad), value=float("-inf"))
    lo = lo.view(B, n_tiles, 128, 3).amin(2)[:, None]  # (B, 1, tiles, 3)
    hi = hi.view(B, n_tiles, 128, 3).amax(2)[:, None]
    c = ctr[:, :, None, :]
    g = torch.where(lo > c, lo - c, torch.where(c > hi, c - hi, torch.zeros_like(c)))
    lb = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    reach = ~(lb >= float(np.float32(max(radii) ** 2)))  # (B, M, tiles)
    start = torch.arange(n_tiles, device=sup.device) * 128
    in_tile = (need[..., None] - start).clamp(0, 128)  # of each tile, before the scan ends
    return int(need.sum()), int((in_tile * reach).sum())


def iou_pairs_needed(boxes):
    """Unordered pairs of distinct boxes whose circumscribed circles meet:
    the only pairs whose IoU needs the polygon clip."""
    import torch

    r = 0.5 * torch.hypot(boxes[..., 3], boxes[..., 4])
    d = torch.cdist(boxes[..., :2], boxes[..., :2])
    meet = d <= r[..., :, None] + r[..., None, :]
    return int(torch.triu(meet, diagonal=1).sum())


def check_kernels(dev, parent=None):
    """Phase 3: each kernel against its plain version at main-path shapes.
    Returns per kernel the largest error and, at its headline shape, the
    times and the bound.  ``parent``: the FPS, ball-query and attention
    wrappers of another tree, timed in turns beside this tree's (the
    attention in float32, at every main-path shape)."""
    import torch

    from pdanet_tpu_torch.ops import attention, ball_query, nms, rotated_iou, sampling

    stats = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None, "bound_ms": None,
                 "bound_by": None, "library_ms": None} for k in KERNELS}

    def record(name, err, kern_fn, plain_fn, headline, what, bnd, lib_fn=None):
        if lib_fn is None:
            kern_ms, lib_ms = cuda_ms(kern_fn), None
        else:
            kern_ms, lib_ms = in_turns(kern_fn, lib_fn)
        plain_ms = cuda_ms(plain_fn, reps=PLAIN_REPS, warmup=1)
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], float(err))
        if headline:
            st.update(ms=kern_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd[0],
                      bound_by=bnd[1])
        line = (f"{name:27s} {what}: max_abs_err {err:.3g}; kernel {kern_ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms")
        if lib_ms is not None:
            line += f", SDPA {lib_ms:.4f} ms"
        print(line + f"; bound {bnd[0]:.4f} ms ({bnd[1]}), kernel at "
              f"{100 * bnd[0] / kern_ms:.1f} % of it")
        return kern_ms

    def idx_err(a, b):
        return (a.long() - b.long()).abs().max().item()

    for B in (1, 2):
        pts = torch.from_numpy(lidar_like_cloud(B, B, N_POINTS)).to(dev)
        xyz = pts[..., :3].contiguous()
        k_idx = sampling.farthest_point_sample_cuda(xyz, 4096)
        p_idx = sampling.farthest_point_sample_plain(xyz, 4096)
        require(torch.equal(k_idx, p_idx), f"FPS B={B} indices differ from the plain version")
        # per step and point: 3 sub, 3 mul, 2 add, the min and the argmax compare
        ms = record("fps", idx_err(k_idx, p_idx),
                    lambda: sampling.farthest_point_sample_cuda(xyz, 4096),
                    lambda: sampling.farthest_point_sample_plain(xyz, 4096),
                    B == 1, f"B={B} 16384->4096 equal",
                    bound(xyz.numel() * 4 + k_idx.numel() * 4, B * 4096 * N_POINTS * 10,
                          F32_OPS_PER_S))
        print(f"{'fps':27s} B={B} 16384->4096: {1e3 * ms / 4095:.4f} us per serial step, "
              f"launch shape (cluster, threads, points per thread, chunk skip) "
              f"{sampling.fps_config(N_POINTS)}")

        sa0_ctr = torch.gather(xyz, 1, k_idx.long()[..., None].expand(B, 4096, 3)).contiguous()
        sa1_ctr = sa0_ctr[:, :1024].contiguous()
        for label, sup, ctr, radii, ks in (
            ("SA0", xyz, sa0_ctr, (0.2, 0.8), (16, 32)),
            ("SA1", sa0_ctr, sa1_ctr, (0.8, 1.6), (16, 32)),
        ):
            got = ball_query.ball_query_multi_cuda(radii, ks, sup, ctr)
            want = ball_query.ball_query_multi_plain(radii, ks, sup, ctr)
            for g, w in zip(got, want):
                require(torch.equal(g, w), f"ball query {label} B={B} differs from the plain version")
            # per point of a tile in reach, before the first-K scan ends:
            # the distance (3 sub, 3 mul, 2 add) and a compare per radius
            scan, in_reach = ball_query_work(radii, ks, sup, ctr)
            record("ball_query", max(idx_err(g, w) for g, w in zip(got, want)),
                   lambda: ball_query.ball_query_multi_cuda(radii, ks, sup, ctr),
                   lambda: ball_query.ball_query_multi_plain(radii, ks, sup, ctr),
                   B == 1 and label == "SA0",
                   f"{label} B={B} N={sup.shape[1]} M={ctr.shape[1]} equal, per centre "
                   f"{scan / ctr.shape[1] / B:.0f} points in a first-K scan, "
                   f"{in_reach / ctr.shape[1] / B:.0f} of them in tiles within reach",
                   bound((sup.numel() + ctr.numel() + sum(w.numel() for w in want)) * 4,
                         in_reach * (8 + len(radii)), F32_OPS_PER_S))
            print_ball_query_work(f"{label} B={B}", radii, ks, sup, ctr, (scan, in_reach))

        rs = np.random.RandomState(B)
        for label, M, hd in ATTN_SHAPES:
            for K in (16, 32):
                R, D = B * M * K, 4 * hd
                qkv32 = [torch.from_numpy(rs.randn(R, D).astype(np.float32)).to(dev)
                         for _ in range(3)]
                for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-2)):
                    q, k, v = (t.to(dt) for t in qkv32)
                    got = attention.neighbor_attention_flat_cuda(q, k, v, K, 4, hd)
                    want = attention.neighbor_attention_flat_plain(q, k, v, K, 4, hd)
                    lib_call, lib_flat = sdpa_forward(q, k, v, K, 4, hd)
                    err = (got.float() - want.float()).abs().max().item()
                    lib_err = (lib_flat().float() - want.float()).abs().max().item()
                    require(got.dtype == dt and err <= tol,
                            f"attention {label} K={K} {dt} err {err} > {tol}")
                    require(lib_err <= tol,
                            f"SDPA {label} K={K} {dt} differs from the plain version: "
                            f"{lib_err} > {tol}")
                    name = "neighbor_attention_bf16" if dt == torch.bfloat16 else \
                        "neighbor_attention"
                    headline = B == 1 and label == "SA1" and K == 32
                    what = f"{label} B={B} K={K} hd={hd} {str(dt)[6:]} (SDPA err {lib_err:.3g})"
                    record(name, err,
                           lambda: attention.neighbor_attention_flat_cuda(q, k, v, K, 4, hd),
                           lambda: attention.neighbor_attention_flat_plain(q, k, v, K, 4, hd),
                           headline, what, attention_bound(R, K, 4, hd, dt), lib_call)
                    if parent and dt == torch.float32:
                        vs_parent(f"float32 attention {label} B={B} K={K} hd={hd}",
                                  lambda: attention.neighbor_attention_flat_cuda(q, k, v, K, 4, hd),
                                  lambda: parent.attention.neighbor_attention_flat_cuda(
                                      q, k, v, K, 4, hd), device_name="attn_kernel")
                    if headline:
                        kern_cold, lib_cold = in_turns(
                            lambda: attention.neighbor_attention_flat_cuda(q, k, v, K, 4, hd),
                            lib_call, cold=True)
                        print(f"{name:27s} {label} B={B} K={K} {str(dt)[6:]} with the L2 "
                              f"flushed before each run: kernel {kern_cold:.4f} ms, SDPA "
                              f"{lib_cold:.4f} ms; SDPA ran {kernel_names(lib_call)}")

        boxes = torch.from_numpy(random_boxes(B, B, 256)).to(dev)
        iou = rotated_iou.boxes_iou_bev_batched_self_cuda(boxes)
        want = rotated_iou.boxes_iou_bev_batched_self_plain(boxes)
        err = (iou - want).abs().max().item()
        require(torch.allclose(iou, want, rtol=2e-4, atol=2e-5),
                f"IoU B={B} outside rtol 2e-4 / atol 2e-5 (max err {err})")
        diag = torch.diagonal(iou, dim1=1, dim2=2)
        require(torch.allclose(diag, torch.ones_like(diag), rtol=1e-5, atol=0),
                f"IoU B={B}: the diagonal is not 1")
        pairs = iou_pairs_needed(boxes)
        record("rotated_iou", err,
               lambda: rotated_iou.boxes_iou_bev_batched_self_cuda(boxes),
               lambda: rotated_iou.boxes_iou_bev_batched_self_plain(boxes),
               B == 1, f"B={B} K=256, {pairs} pairs whose circles meet",
               bound((boxes.numel() + iou.numel()) * 4, pairs * IOU_PAIR_OPS, F32_OPS_PER_S))

        valid = torch.from_numpy(np.random.RandomState(B).rand(B, 256) > 0.1).to(dev)
        k_keep = nms.greedy_nms_mask_batched_cuda(iou, valid, 0.01)
        p_keep = nms.greedy_nms_mask_batched_plain(iou, valid, 0.01)
        require(torch.equal(k_keep, p_keep), f"NMS B={B} keep mask differs from the plain version")
        # the walk reads the row right of the diagonal of each kept box and
        # compares each entry once
        row_reads = int((255 - torch.nonzero(k_keep)[:, 1]).sum())
        record("nms", idx_err(k_keep, p_keep),
               lambda: nms.greedy_nms_mask_batched_cuda(iou, valid, 0.01),
               lambda: nms.greedy_nms_mask_batched_plain(iou, valid, 0.01),
               B == 1, f"B={B} K=256 equal, {int(k_keep.sum())} kept",
               bound(row_reads * 4 + valid.numel() + k_keep.numel(), row_reads, F32_OPS_PER_S))
        if parent:
            vs_parent(f"IoU B={B} K=256",
                      lambda: rotated_iou.boxes_iou_bev_batched_self_cuda(boxes),
                      lambda: parent.rotated_iou.boxes_iou_bev_batched_self_cuda(boxes),
                      device_name="iou_self_kernel")
            vs_parent(f"NMS B={B} K=256",
                      lambda: nms.greedy_nms_mask_batched_cuda(iou, valid, 0.01),
                      lambda: parent.nms.greedy_nms_mask_batched_cuda(iou, valid, 0.01),
                      device_name="nms_")

    check_fps_ball_query(dev, parent)
    check_iou_nms(dev, stats, parent)

    # shapes off the KITTI path that the attention kernels take as well: K
    # 64 (opt-in shared memory), K 8 and, in bfloat16, K and hd that pad to
    # other tiles
    rs = np.random.RandomState(3)
    errs = []
    for K, hd in ATTN_OFF_PATH:
        qkv32 = [torch.from_numpy(rs.randn(64 * K, 4 * hd).astype(np.float32)).to(dev)
                 for _ in range(3)]
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 5e-2)):
            q, k, v = (t.to(dt) for t in qkv32)
            err = (attention.neighbor_attention_flat_cuda(q, k, v, K, 4, hd).float()
                   - attention.neighbor_attention_flat_plain(q, k, v, K, 4, hd).float()
                   ).abs().max().item()
            require(err <= tol, f"attention K={K} hd={hd} {dt} err {err} > {tol}")
            name = "neighbor_attention_bf16" if dt == torch.bfloat16 else "neighbor_attention"
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            errs.append(f"K={K}/hd={hd} {str(dt)[6:]} {err:.3g}")
    print("off-path shapes: attention max abs err " + ", ".join(errs))
    return stats


def skip_pair_boxes(seed, P, gaps, square=60.0, odd=True):
    """P pairs of boxes (P, 2, 7), float32, whose centres lie r_a + r_b +
    gap apart (r: a box's circumradius), gap uniform in ``gaps``: the edge
    of the IoU kernel's circle skip (``kSkipSlack``, csrc/rotated_iou.cu).
    Even pairs sit corner to corner, a corner of each box on the line
    between the centres, where the 1e-2 containment margin is tightest; odd
    pairs in random directions.  Extents 0.5-4.5 m; with ``odd`` one box in
    eight zero-size and one in eight a 1e-3 m sliver.  First boxes at
    random in a square of side ``square`` m centred on 0."""
    rs = np.random.RandomState(seed)
    size = rs.uniform(0.5, 4.5, (P, 2, 2))
    if odd:
        kind = rs.randint(0, 8, (P, 2))
        size[kind == 0] = 0.0
        size[..., 0] = np.where(kind == 1, 1e-3, size[..., 0])
    head = rs.uniform(-np.pi, np.pi, (P, 2))
    r = 0.5 * np.hypot(size[..., 0], size[..., 1])
    gap = rs.uniform(gaps[0], gaps[1], P)
    aligned = np.arange(P) % 2 == 0
    # a's corner (hx, hy) points at b and b's corner (-hx, -hy) back at a
    phi = np.where(aligned, head[:, 0] + np.arctan2(size[:, 0, 1], size[:, 0, 0]),
                   rs.uniform(-np.pi, np.pi, P))
    head[:, 1] = np.where(aligned, phi - np.arctan2(size[:, 1, 1], size[:, 1, 0]), head[:, 1])
    ca = rs.uniform(-square / 2, square / 2, (P, 2))
    dist = r[:, 0] + r[:, 1] + gap
    out = np.zeros((P, 2, 7), np.float32)
    out[:, 0, 0:2] = ca
    out[:, 1, 0] = ca[:, 0] + dist * np.cos(phi)
    out[:, 1, 1] = ca[:, 1] + dist * np.sin(phi)
    out[..., 2] = -0.5
    out[..., 3:5] = size
    out[..., 5] = 1.5
    out[..., 6] = np.angle(np.exp(1j * head))
    return out


# two pairs of PointRCNN's seeded proposal boxes whose IoU the kernel gave
# 0.3 % (and half) off its plain version while it took cosf / sinf
MARGIN_PAIRS = ((4.816701889038086, -3.700716733932495, -0.5751507878303528, 3.881711006164551,
                 1.6010545492172241, 1.5572998523712158, -1.0846593379974365),
                (2.2110655307769775, -2.2371928691864014, -1.749772310256958, 3.8819379806518555,
                 1.601021647453308, 1.5573476552963257, -1.0691578388214111),
                (41.889862060546875, 13.674456596374512, -1.703295111656189, 3.881639242172241,
                 1.6010240316390991, 1.5572230815887451, -1.0984846353530884),
                (42.366661071777344, 12.80897331237793, -1.6941862106323242, 3.8818917274475098,
                 1.6010488271713257, 1.5572954416275024, -1.0877596139907837))
NMS_SIZES = (1, 63, 64, 65, 256, 1024, 4096)  # K; from 1024 on a synthetic sparse IoU
# K beyond 4096 (the walk's five-words-a-lane instantiation), with B: fewer
# cases each, the plain walk taking about a second at K 10240
NMS_LARGE = ((4097, 1), (9000, 2), (10240, 1))


def sparse_iou(seed, B, K, dev, per_row=4.0):
    """A synthetic (B, K, K) float32 IoU matrix: each entry uniform in
    (0, 1) with probability ``per_row`` / K, else 0: a walk keeps 30-70 %
    of the candidates, each of whose rows it ORs."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.rand((B, K, K), generator=g, device=dev)
    hit = torch.rand((B, K, K), generator=g, device=dev) < per_row / K
    return torch.where(hit, vals, torch.zeros_like(vals))


def check_iou_nms(dev, stats, parent=None):
    """Phase 3, the rotated self-IoU and the NMS walk beyond their headline
    shapes.  The IoU within rtol 2e-4 / atol 2e-5 of its plain version,
    the diagonal 1 within 1e-5 (boxes of nonzero area), at spread 12 and 3
    (most pairs meet), B = 1 K = 1024, duplicated boxes, zero-size boxes,
    pairs within 1e-3 m of the circle skip's distance and car-sized boxes
    whose corners lie at the containment margin (``MARGIN_PAIRS``); with ``parent``
    also against that tree's kernel, bit for bit or the differing pairs
    printed, and timed in turns beside it.  The NMS keep mask equal to the
    plain version at every K of NMS_SIZES, thresh 0.01, 0.1 and 0.7, valid
    all, none and random; its device time per serial step at K 256, 1024
    and 4096, and with ``parent`` timed in turns beside that tree's at
    K 1024."""
    import torch

    from pdanet_tpu_torch.ops import nms, rotated_iou

    rs = np.random.RandomState(40)
    dup = random_boxes(41, 1, 128, 6.0)
    dup = np.concatenate([dup, dup], 1)[:, rs.permutation(256)]
    zero = random_boxes(42, 1, 256, 6.0)
    kind = rs.randint(0, 4, 256)
    zero[0, kind == 1, 3] = 0.0
    zero[0, kind == 2, 4] = 0.0
    zero[0, kind == 3, 3:5] = 0.0
    edge = skip_pair_boxes(43, 128, (rotated_iou.SKIP_SLACK - 1e-3, rotated_iou.SKIP_SLACK + 1e-3),
                           square=24.0, odd=False).reshape(1, 256, 7)
    # car-sized boxes a few centimetres and ~0.01 rad apart, as PointRCNN's
    # seeded per-point proposals are: 252 drawn, and two pairs of its
    # proposals where a corner lies within rounding of the other box's
    # containment margin, so that an ulp of the corner (cosf against the
    # plain version's cos rounded from double) moved the IoU by up to 0.3 %
    cars = np.concatenate([rs.uniform([0, 0, -1], [3, 3, 0], (1, 252, 3)),
                           rs.normal([3.88, 1.601, 1.557, -1.08], [2e-4, 3e-5, 3e-5, 1e-2],
                                     (1, 252, 4))], -1)
    margin = np.array(MARGIN_PAIRS, np.float64)[None]
    cars = np.concatenate([cars, margin], 1).astype(np.float32)
    cases = (("spread 12 B=2 K=256", random_boxes(44, 2, 256, 12.0)),
             ("spread 3 B=1 K=256", random_boxes(45, 1, 256, 3.0)),
             ("spread 3 B=2 K=256", random_boxes(46, 2, 256, 3.0)),
             ("spread 24 B=1 K=1024", random_boxes(47, 1, 1024, 24.0)),
             ("duplicated boxes K=256", dup), ("zero-size boxes K=256", zero),
             ("pairs within 1e-3 m of the skip distance K=256", edge),
             ("car-sized boxes 0.01 rad apart, corners at the containment margin K=256", cars))
    for what, arr in cases:
        boxes = torch.from_numpy(arr).to(dev)
        got = rotated_iou.boxes_iou_bev_batched_self_cuda(boxes)
        want = rotated_iou.boxes_iou_bev_batched_self_plain(boxes)
        err = (got - want).abs().max().item()
        require(torch.allclose(got, want, rtol=2e-4, atol=2e-5),
                f"IoU {what} outside rtol 2e-4 / atol 2e-5 (max err {err})")
        diag = torch.diagonal(got, dim1=1, dim2=2)[boxes[..., 3] * boxes[..., 4] > 0]
        require(torch.allclose(diag, torch.ones_like(diag), rtol=1e-5, atol=0),
                f"IoU {what}: the diagonal is not 1")
        stats["rotated_iou"]["max_abs_err"] = max(stats["rotated_iou"]["max_abs_err"], err)

        def kern():
            return rotated_iou.boxes_iou_bev_batched_self_cuda(boxes)

        line = (f"{'rotated_iou':27s} {what}: max_abs_err {err:.3g}, "
                f"{iou_pairs_needed(boxes)} pairs whose circles meet")
        if not parent:
            line += f", device time {fmt_ms(kernel_device_ms(kern, 'iou_self_kernel'))}"
        else:
            old = parent.rotated_iou.boxes_iou_bev_batched_self_cuda(boxes)
            diff = (got != old) & ~(got.isnan() & old.isnan())
            if bool(diff.any()):
                idx = torch.nonzero(diff)[:5].tolist()
                line += (f"; differs from the parent's kernel at {int(diff.sum())} pairs, by up "
                         f"to {(got - old)[diff].abs().max().item():.3g} (first {idx})")
            else:
                line += "; bit for bit the parent's kernel"
        print(line)
        if parent:
            vs_parent(f"IoU {what}", kern,
                      lambda: parent.rotated_iou.boxes_iou_bev_batched_self_cuda(boxes),
                      device_name="iou_self_kernel")

    check_nonfinite_iou_nms(dev, stats)

    for K in NMS_SIZES:
        if K <= 256:
            iou = rotated_iou.boxes_iou_bev_batched_self_cuda(
                torch.from_numpy(random_boxes(50 + K, 1, K, 12.0 * np.sqrt(K / 256))).to(dev))
        else:
            iou = sparse_iou(60 + K, 1, K, dev)
        kept = []
        for thresh in (0.01, 0.1, 0.7):
            for pattern in ("all", "none", "random"):
                valid = {"all": torch.ones((1, K), dtype=torch.bool, device=dev),
                         "none": torch.zeros((1, K), dtype=torch.bool, device=dev),
                         "random": torch.from_numpy(rs.rand(1, K) > 0.1).to(dev)}[pattern]
                got = nms.greedy_nms_mask_batched_cuda(iou, valid, thresh)
                want = nms.greedy_nms_mask_batched_plain(iou, valid, thresh)
                require(torch.equal(got, want),
                        f"NMS K={K} thresh {thresh} valid {pattern}: keep mask differs from "
                        f"the plain version")
                kept.append(int(got.sum()))
        line = (f"{'nms':27s} K={K}{' (sparse IoU)' if K > 256 else ''}: keep mask equal at "
                f"thresh 0.01/0.1/0.7 x valid all/none/random, kept {kept}")
        if K >= 256:
            valid = torch.from_numpy(rs.rand(1, K) > 0.1).to(dev)

            def kern():
                return nms.greedy_nms_mask_batched_cuda(iou, valid, 0.1)

            ms = [kernel_device_ms(kern, name)
                  for name in ("nms_", "nms_mask_kernel", "nms_walk_kernel")]
            line += (f"; thresh 0.1 random valid: device time {fmt_ms(ms[0])} (words "
                     f"{fmt_ms(ms[1])}, walk {fmt_ms(ms[2])})")
            if ms[0] is not None:
                line += f", {1e3 * ms[0] / K:.4f} us per serial step"
        print(line)
        if parent and K == 1024:
            vs_parent("NMS B=1 K=1024 (sparse IoU)", kern,
                      lambda: parent.nms.greedy_nms_mask_batched_cuda(iou, valid, 0.1),
                      device_name="nms_")
    for K, B in NMS_LARGE:
        iou = sparse_iou(60 + K, B, K, dev)
        valid = torch.from_numpy(rs.rand(B, K) > 0.1).to(dev)
        kept = []
        for thresh in (0.1, 0.8):
            got = nms.greedy_nms_mask_batched_cuda(iou, valid, thresh)
            want = nms.greedy_nms_mask_batched_plain(iou, valid, thresh)
            require(torch.equal(got, want), f"NMS B={B} K={K} thresh {thresh}: keep mask "
                    f"differs from the plain version")
            kept.append(got.sum(dim=1).tolist())
        ms = [kernel_device_ms(lambda: nms.greedy_nms_mask_batched_cuda(iou, valid, 0.1), name)
              for name in ("nms_", "nms_mask_kernel", "nms_walk_kernel")]
        print(f"{'nms':27s} B={B} K={K} (sparse IoU): keep mask equal at thresh 0.1/0.8, "
              f"random valid, kept {kept}; thresh 0.1: device time {fmt_ms(ms[0])} (words "
              f"{fmt_ms(ms[1])}, walk {fmt_ms(ms[2])})"
              + (f", {1e3 * ms[0] / K:.4f} us per serial step" if ms[0] is not None else ""))
        del iou


NONFINITE = ((0, np.inf), (1, -np.inf), (3, np.inf), (4, np.nan), (6, np.nan), (0, np.nan),
             (6, np.inf), (3, 0.0), (4, 0.0), (1, np.nan), (4, np.inf), (3, np.nan))


def nonfinite_boxes(seed, B, K, spread=12.0):
    """``random_boxes`` with every 7th box given one of ``NONFINITE`` (an
    inf, -inf or NaN in x, y, dx, dy or the heading, or a zero extent), in
    turn, and one finite box's copy with an infinite length."""
    arr = random_boxes(seed, B, K, spread)
    for n, i in enumerate(range(3, K, 7)):
        col, val = NONFINITE[n % len(NONFINITE)]
        arr[:, i, col] = val
    arr[:, 1] = arr[:, 0]
    arr[:, 1, 3] = np.inf
    return arr


def check_nonfinite_iou_nms(dev, stats):
    """Phase 3: the rotated self-IoU and the NMS walk on boxes with inf,
    -inf or NaN in x, y, dx, dy or the heading, and zero extents (what an
    unclamped ``exp`` of a seeded model's box code gives): the IoU NaN and
    infinite at the same pairs as its plain version, the rest within rtol
    2e-4 / atol 2e-5; the keep mask equal to the plain version's, fed the
    kernel's IoU, at thresh 0.01, 0.1 and 0.7.  ``tests/
    test_torch_centerpoint.py`` holds the plain versions to the JAX
    package's on such boxes."""
    import torch

    from pdanet_tpu_torch.ops import nms, rotated_iou

    rs = np.random.RandomState(48)
    for B, K, spread in ((1, 256, 6.0), (2, 500, 12.0)):
        boxes = torch.from_numpy(nonfinite_boxes(48 + K, B, K, spread)).to(dev)
        got = rotated_iou.boxes_iou_bev_batched_self_cuda(boxes)
        want = rotated_iou.boxes_iou_bev_batched_self_plain(boxes)
        same_nan = torch.equal(got.isnan(), want.isnan())
        same_inf = torch.equal(got.isinf(), want.isinf())
        fin = torch.isfinite(want)
        err = (got[fin] - want[fin]).abs().max().item()
        where = torch.nonzero(got.isnan() != want.isnan())[:5].tolist()
        require(same_nan and same_inf, f"IoU on non-finite boxes B={B} K={K}: NaN / inf at "
                f"other pairs than the plain version's (first {where})")
        require(torch.allclose(got[fin], want[fin], rtol=2e-4, atol=2e-5),
                f"IoU on non-finite boxes B={B} K={K} outside rtol 2e-4 / atol 2e-5 ({err})")
        stats["rotated_iou"]["max_abs_err"] = max(stats["rotated_iou"]["max_abs_err"], err)
        valid = torch.from_numpy(rs.rand(B, K) > 0.1).to(dev)
        kept = []
        for thresh in (0.01, 0.1, 0.7):
            keep = nms.greedy_nms_mask_batched_cuda(got, valid, thresh)
            require(torch.equal(keep, nms.greedy_nms_mask_batched_plain(got, valid, thresh)),
                    f"NMS on non-finite boxes B={B} K={K} thresh {thresh}: keep mask differs")
            kept.append(keep.sum(dim=1).tolist())
        print(f"{'rotated_iou / nms':27s} non-finite boxes B={B} K={K}: "
              f"{int(torch.isnan(want).sum())} NaN IoUs at the plain version's pairs, finite "
              f"ones within {err:.3g}; keep masks equal at thresh 0.01/0.1/0.7, kept {kept}")


def kernel_device_ms(fn, name, reps=20):
    """Median device time, over ``reps`` runs of ``fn`` under
    torch.profiler, of the kernels whose names hold ``name``, summed over
    each run where a run launches several (the kernels alone, without the
    host's launch gap that a CUDA-event time of a short call includes);
    None when the profiler cannot trace the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without the kernels
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        except RuntimeError:
            return None
        times = [ms for _, ms in sorted(
            (e.time_range.start, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name)]
        if times:
            # kernels a run; a trace can miss the first kernel it sees, so
            # runs are counted back from the last kernel
            per = max(1, round(len(times) / reps))
            times = times[len(times) % per:]
            return statistics.median(sum(times[k:k + per]) for k in range(0, len(times), per))
    return None


def fmt_ms(ms):
    return "not traced" if ms is None else f"{ms:.4f} ms"


def vs_parent(what, new_fn, old_fn, reps=50, device_name=None):
    """Another tree's kernel (``old_fn``) and this tree's timed in turns
    under CUDA events and, with ``device_name``, their device time alone
    under the profiler, also in turns.  Returns (parent, this tree) CUDA-
    event milliseconds."""
    new_ms, old_ms = in_turns(new_fn, old_fn, reps=reps)
    line = (f"parent against this tree, {what}: CUDA events parent {old_ms:.4f} ms, "
            f"this tree {new_ms:.4f} ms ({old_ms / new_ms:.2f}x)")
    if device_name:  # device time alone, in turns
        a1, b1 = (kernel_device_ms(f, device_name) for f in (old_fn, new_fn))
        b2, a2 = (kernel_device_ms(f, device_name) for f in (new_fn, old_fn))
        if None not in (a1, a2, b1, b2):
            old_dev, new_dev = (a1 + a2) / 2, (b1 + b2) / 2
            line += (f"; device parent {old_dev:.4f} ms, this tree {new_dev:.4f} ms "
                     f"({old_dev / new_dev:.2f}x)")
    print(line)
    return old_ms, new_ms


def print_ball_query_work(what, radii, ks, sup, ctr, work=None):
    """The ball query's tile skip on these inputs: the share of (centre,
    128-point tile) tests that proved the tile out of reach, the points the
    kernel scanned beside those of ``ball_query_work`` (``work``, counted
    here if not given), the bytes and operations bounds apart, and the
    kernel's device time under the profiler."""
    import torch

    from pdanet_tpu_torch.ops import ball_query

    st = torch.zeros(3, dtype=torch.int64, device=sup.device)
    outs = ball_query.ball_query_multi_cuda(radii, ks, sup, ctr, stats=st)
    tests, reach, tiles = st.tolist()
    centres = ctr.shape[0] * ctr.shape[1]
    scan, in_reach = ball_query_work(radii, ks, sup, ctr) if work is None else work
    n_bytes = (sup.numel() + ctr.numel() + sum(o.numel() for o in outs)) * 4
    n_ops = in_reach * (8 + len(radii))
    dev_ms = kernel_device_ms(lambda: ball_query.ball_query_multi_cuda(radii, ks, sup, ctr),
                              "ball_query_kernel")
    print(f"{'ball_query':27s} {what}: {100 * (tests - reach) / max(tests, 1):.1f} % of "
          f"{tests} (centre, tile) tests skipped; per centre the kernel scanned at most "
          f"{128 * tiles / centres:.0f} points, a first-K scan visits {scan / centres:.0f}, "
          f"{in_reach / centres:.0f} of them in tiles within reach; bytes bound "
          f"{1e3 * n_bytes / HBM_BYTES_PER_S:.5f} ms, operations bound "
          f"{1e3 * n_ops / F32_OPS_PER_S:.5f} ms; device time {fmt_ms(dev_ms)}")


def shuffled(x, seed):
    """``x`` (B, N, ...) with its points in a seeded random order."""
    import torch

    perm = torch.from_numpy(np.random.RandomState(seed).permutation(x.shape[1]))
    return x[:, perm.to(x.device)].contiguous()


def boundary_cloud(radii, seed=11):
    """Support points at float32 distances around each radius: 16 centres
    (0, 32 k, 0) and the points (+-d, 32 k, 0), so that d2 is fl(d * d)
    with or without FMA contraction, for every float32 d within 3 ulps of
    float32(r) and of float32(sqrt(float32(r * r))); with 64 seeded points
    around each centre, all in a seeded order.  Returns numpy (1, N, 3),
    (1, 16, 3).  The CPU tests (tests/test_torch_ops.py) take it from
    here."""
    rs = np.random.RandomState(seed)
    ctr = np.zeros((16, 3), np.float32)
    ctr[:, 1] = 32 * np.arange(16)
    ds = set()
    for r in radii:
        for base in (np.float32(r), np.float32(np.sqrt(np.float32(r * r)))):
            d = base
            for _ in range(3):
                d = np.nextafter(d, np.float32(0))
            for _ in range(7):
                ds.add(float(d))
                d = np.nextafter(d, np.float32(np.inf))
    ds = np.asarray(sorted(ds), np.float32)
    rmax = max(radii)
    pts = []
    for c in ctr:
        for sign in (1, -1):
            p = np.repeat(c[None], len(ds), 0)
            p[:, 0] = sign * ds
            pts.append(p)
        pts.append(c + rs.uniform(-rmax, rmax, (64, 3)).astype(np.float32))
    sup = np.concatenate(pts).astype(np.float32)
    return sup[rs.permutation(len(sup))][None], ctr[None]


# FPS clouds that reach every instantiation of csrc/fps.cu the launch
# shape of N picks, (N, npoint): 128 threads a CTA with 1, 2, 4, 8 and 16
# points a thread (one CTA up to 2048 points, N = 100 below its width),
# 16 at 4 CTAs (5000), 32 at 16 CTAs (40000, and ONCE's 60000 timed
# apart); 256 threads with 32 points a thread (100000) and in global
# memory (200000)
FPS_SIZES = ((100, 64), (200, 150), (500, 400), (1000, 1000), (2000, 512), (5000, 1000),
             (40000, 1024), (100000, 256), (200000, 64))


def ball_query_shapes(xyz, idx):
    """The ball query's main-path calls on frames ``xyz`` (B, 16384, 3)
    with their D-FPS picks ``idx`` (B, 4096), as (label, support, centres,
    radii, K): SA0 (the raw x-sorted cloud), SA1 and SA2 (FPS-ordered
    supports), SA5 (vote centres around SA3's points)."""
    import torch

    B, dev = xyz.shape[0], xyz.device
    sa0 = torch.gather(xyz, 1, idx.long()[..., None].expand(*idx.shape, 3)).contiguous()
    rs = np.random.RandomState(30 + B)
    sa2 = sa0[:, torch.from_numpy(rs.permutation(1024)[:512]).to(dev)].contiguous()
    sa3 = sa2[:, :256].contiguous()
    votes = sa3 + torch.from_numpy(rs.randn(B, 256, 3).astype(np.float32) * 0.3).to(dev)
    return (("SA0", xyz, sa0, (0.2, 0.8), (16, 32)),
            ("SA1", sa0, sa0[:, :1024].contiguous(), (0.8, 1.6), (16, 32)),
            ("SA2", sa0[:, :1024].contiguous(), sa2, (1.6, 4.8), (16, 32)),
            ("SA5", sa3, votes, (4.8, 6.4), (16, 32)))


def check_fps_ball_query(dev, parent=None):
    """Phase 3, FPS and the ball query beyond their headline shapes, each
    held equal to its plain version: FPS at B = 1, 2, 4 (16384 -> 4096),
    on ONCE's 60000 -> 16384 (timed), at every N of FPS_SIZES (every
    instantiation the launch shape picks, N = 100 below one CTA's width),
    on a shuffled cloud and on clouds whose duplicated points tie across
    CTA slices; the ball query at the SA0, SA1, SA2 and SA5 shapes at B = 1
    and 4, ONCE SA5's three radii, a shuffled support, shuffled centres
    and points within 3 float32 ulps of each radius.  With ``parent``
    (another tree's ``sampling`` and ``ball_query`` modules), each
    main-path shape is timed in turns against it."""
    import torch

    from pdanet_tpu_torch.ops import ball_query, sampling

    def fps_equal(what, xyz, npoint):
        got = sampling.farthest_point_sample_cuda(xyz, npoint)
        require(torch.equal(got, sampling.farthest_point_sample_plain(xyz, npoint)),
                f"FPS {what} differs from the plain version")
        return got

    def bq_equal(what, radii, ks, sup, ctr):
        got = ball_query.ball_query_multi_cuda(radii, ks, sup, ctr)
        want = ball_query.ball_query_multi_plain(radii, ks, sup, ctr)
        for g, w in zip(got, want):
            require(torch.equal(g, w),
                    f"ball query {what} K={w.shape[-1]} differs from the plain version")

    def fps_fn(mod, xyz, npoint):
        return lambda: mod.farthest_point_sample_cuda(xyz, npoint)

    frames = {B: torch.from_numpy(lidar_like_cloud(B, B, N_POINTS)[..., :3].copy()).to(dev)
              for B in (1, 2, 4)}
    # FPS on the main path: b1 and b2 serving, B = 4 training
    for B, xyz in frames.items():
        fps_equal(f"B={B} 16384->4096", xyz, 4096)
        ms = cuda_ms(fps_fn(sampling, xyz, 4096))
        print(f"{'fps':27s} B={B} 16384->4096 equal: {ms:.4f} ms, {1e3 * ms / 4095:.4f} us per "
              f"step, launch shape (cluster, threads, points per thread, chunk skip) "
              f"{sampling.fps_config(N_POINTS)}")
        if parent:
            vs_parent(f"FPS B={B} 16384->4096", fps_fn(sampling, xyz, 4096),
                      fps_fn(parent.sampling, xyz, 4096))

    # off the KITTI path: ONCE's 60000 points, then every instantiation
    once = torch.from_numpy(lidar_like_cloud(7, 1, 60000)[..., :3].copy()).to(dev)
    once_idx = fps_equal("N=60000->16384", once, 16384)
    ms = cuda_ms(fps_fn(sampling, once, 16384), reps=5)
    print(f"{'fps':27s} ONCE N=60000->16384 equal: {ms:.4f} ms, {1e3 * ms / 16383:.4f} us per "
          f"step, launch shape {sampling.fps_config(60000)}")
    if parent:
        vs_parent("FPS ONCE N=60000->16384", fps_fn(sampling, once, 16384),
                  fps_fn(parent.sampling, once, 16384), reps=5)
    big = torch.from_numpy(
        np.random.RandomState(8).rand(1, 200000, 3).astype(np.float32) * 80).to(dev)
    for N, npoint in FPS_SIZES:
        fps_equal(f"N={N}->{npoint}", (once if N <= 60000 else big)[:, :N].contiguous(), npoint)
    # cloud order and ties
    xyz = frames[1]
    fps_equal("shuffled cloud", shuffled(xyz, 21), 4096)
    dup, half = xyz.clone(), xyz.shape[1] // 2
    dup[:, half:2 * half] = shuffled(xyz[:, :half], 22)
    fps_equal("every point twice, the copies in other CTAs' slices", dup, 4096)
    fps_equal("1024 points repeated 16 times", xyz[:, :1024].repeat(1, 16, 1).contiguous(), 4096)
    print(f"{'fps':27s} equal at (N, launch shape) "
          + ", ".join(f"({n}, {sampling.fps_config(n)})" for n, _ in FPS_SIZES)
          + ", on a shuffled cloud and on two clouds of duplicates")

    # the ball query on the main path
    for B in (1, 4):
        xyz = frames[B]
        idx = sampling.farthest_point_sample_cuda(xyz, 4096)
        for label, sup, ctr, radii, ks in ball_query_shapes(xyz, idx):
            what = f"{label} B={B} N={sup.shape[1]} M={ctr.shape[1]}"
            bq_equal(what, radii, ks, sup, ctr)
            print_ball_query_work(what + " equal", radii, ks, sup, ctr)
            if parent:
                vs_parent(f"ball query {what}",
                          lambda: ball_query.ball_query_multi_cuda(radii, ks, sup, ctr),
                          lambda: parent.ball_query.ball_query_multi_cuda(radii, ks, sup, ctr),
                          device_name="ball_query_kernel")
            if B == 1 and label == "SA0":
                bq_equal("SA0 shuffled support", radii, ks, shuffled(sup, 23), ctr)
                bq_equal("SA0 shuffled centres", radii, ks, sup, shuffled(ctr, 24))
                print_ball_query_work("SA0 B=1 shuffled support", radii, ks, shuffled(sup, 23),
                                      ctr)
    # ONCE SA5: three radii up to K 64 around vote centres of SA3's 1024 points
    sa3 = torch.gather(once, 1, once_idx[:, :1024].long()[..., None].expand(1, 1024, 3))
    votes = sa3 + torch.from_numpy(
        np.random.RandomState(25).randn(1, 1024, 3).astype(np.float32) * 0.3).to(dev)
    radii, ks = (4.8, 8.4, 12.8), (16, 32, 64)
    bq_equal("ONCE SA5", radii, ks, sa3.contiguous(), votes.contiguous())
    print_ball_query_work("ONCE SA5 N=1024 M=1024 three radii equal", radii, ks,
                          sa3.contiguous(), votes.contiguous())
    bq_equal("three radii over the raw ONCE cloud", radii, ks, once, once[:, ::40].contiguous())
    # points within 3 float32 ulps of each radius
    for radii, ks in (((0.2, 0.8), (16, 32)), ((1.6, 4.8), (16, 32)),
                      ((4.8, 8.4, 12.8), (16, 32, 64))):
        sup, ctr = (torch.from_numpy(a).to(dev) for a in boundary_cloud(radii))
        bq_equal(f"radii {radii} at the boundary", radii, ks, sup, ctr)
    print(f"{'ball_query':27s} equal on a shuffled support, shuffled centres, ONCE's three "
          f"radii and points within 3 ulps of each radius")


FPS_SWEEP = ((4, 128), (4, 256), (8, 128), (8, 256), (16, 128), (16, 256))  # (cluster, threads)
ATTN_WARPS = (2, 4, 8)  # warps a CTA of the float32 / float64 attention kernels


def sweep(dev):
    """The launch-shape sweep behind the defaults of ``csrc/fps.cu``
    ``config``, ``csrc/ball_query.cu`` ``pick_cpw`` and the attention
    kernels' warps a CTA (``--sweep``, not part of the check): the float32
    attention forward (B = 1, 2) and backward (B = 4) at the main-path
    shapes with 2, 4 and 8 warps a CTA (``-DPDANET_ATTN_WARPS``), device
    time under the profiler; FPS in every (cluster, threads) shape of FPS_SWEEP
    with the chunk skip on and off, at b1 and B = 4 16384 -> 4096 and on
    ONCE's 60000 -> 16384, under CUDA events; the ball query at 1 and 2
    centres per warp at the SA0, SA1, SA2 and SA5 shapes, b1 and B = 4,
    device time under the profiler.  Each forced shape is a build of its
    one source with ``-D`` defines, all started together, run through the
    port's wrappers; each result is held equal to the plain version."""
    import concurrent.futures
    import contextlib

    import torch

    from pdanet_tpu_torch.ops import ball_query, cuda_lib, sampling

    fps_defs = {(C, T, S): (f"PDANET_FPS_CLUSTER={C}", f"PDANET_FPS_THREADS={T}",
                            f"PDANET_FPS_SKIP={S}") for C, T in FPS_SWEEP for S in (1, 0)}
    t0 = time.perf_counter()
    attn_srcs = ("neighbor_attention.cu", "neighbor_attention_bwd.cu")
    with concurrent.futures.ThreadPoolExecutor(len(fps_defs) + 5) as pool:
        fps_jobs = {k: pool.submit(cuda_lib.build, ("fps.cu",), d) for k, d in fps_defs.items()}
        bq_jobs = {c: pool.submit(cuda_lib.build, ("ball_query.cu",), (f"PDANET_BQ_CPW={c}",))
                   for c in (1, 2)}
        attn_jobs = {n: pool.submit(cuda_lib.build, attn_srcs, (f"PDANET_ATTN_WARPS={n}",))
                     for n in ATTN_WARPS}
        fps_libs = {k: cuda_lib.load(job.result()) for k, job in fps_jobs.items()}
        bq_libs = {c: cuda_lib.load(job.result()) for c, job in bq_jobs.items()}
        attn_libs = {n: cuda_lib.load(job.result()) for n, job in attn_jobs.items()}
    print(f"sweep: {len(fps_libs) + len(bq_libs) + len(attn_libs)} builds in "
          f"{time.perf_counter() - t0:.1f} s")

    @contextlib.contextmanager
    def using(lib):  # the wrappers call this build's kernel
        saved = cuda_lib._lib
        cuda_lib._lib = lib
        try:
            yield
        finally:
            cuda_lib._lib = saved

    frames = {B: torch.from_numpy(lidar_like_cloud(B, B, N_POINTS)[..., :3].copy()).to(dev)
              for B in (1, 4)}
    once = torch.from_numpy(lidar_like_cloud(7, 1, 60000)[..., :3].copy()).to(dev)
    for what, xyz, npoint, reps in (("b1 16384->4096", frames[1], 4096, 20),
                                    ("B=4 16384->4096", frames[4], 4096, 10),
                                    ("ONCE 60000->16384", once, 16384, 5)):
        want = sampling.farthest_point_sample_plain(xyz, npoint)
        rows = []
        for (C, T, S), lib in fps_libs.items():
            with using(lib):
                def fn():
                    return sampling.farthest_point_sample_cuda(xyz, npoint)
                require(torch.equal(fn(), want), f"FPS {what} cluster {C} threads {T} skip {S} "
                        f"differs from the plain version")
                ms = cuda_ms(fn, reps=reps)
                shape = sampling.fps_config(xyz.shape[1])
            rows.append(f"C={C} T={T} P={shape[2]} skip {'on' if S else 'off'} {ms:.4f} ms "
                        f"({1e3 * ms / (npoint - 1):.4f} us/step)")
        print(f"sweep fps {what}, all equal (default {sampling.fps_config(xyz.shape[1])}): "
              + "; ".join(rows))
    for B, xyz in frames.items():
        idx = sampling.farthest_point_sample_cuda(xyz, 4096)
        for label, sup, ctr, radii, ks in ball_query_shapes(xyz, idx):
            want = ball_query.ball_query_multi_plain(radii, ks, sup, ctr)
            rows = []
            for cpw, lib in bq_libs.items():
                with using(lib):
                    def fn():
                        return ball_query.ball_query_multi_cuda(radii, ks, sup, ctr)
                    require(all(torch.equal(g, w) for g, w in zip(fn(), want)),
                            f"ball query {label} B={B} cpw {cpw} differs from the plain version")
                    rows.append(f"cpw {cpw} {fmt_ms(kernel_device_ms(fn, 'ball_query_kernel'))}")
            print(f"sweep ball_query {label} B={B} N={sup.shape[1]} M={ctr.shape[1]}, all equal, "
                  f"device time: " + ", ".join(rows))

    # the float32 attention kernels at 2, 4 and 8 warps a CTA
    from pdanet_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(9)
    for label, M, hd in ATTN_SHAPES:
        for K in (16, 32):
            for bwd, B in ((False, 1), (False, 2), (True, 4)):
                ts = [torch.randn(B * M * K, 4 * hd, generator=gen, device=dev) for _ in range(4)]
                if bwd:
                    def fn():
                        return attention.neighbor_attention_flat_bwd_cuda(*ts, K, 4, hd)
                    want = attention.neighbor_attention_flat_bwd_plain(*ts, K, 4, hd)
                else:
                    def fn():
                        return (attention.neighbor_attention_flat_cuda(*ts[:3], K, 4, hd),)
                    want = (attention.neighbor_attention_flat_plain(*ts[:3], K, 4, hd),)
                rows = []
                for n, lib in attn_libs.items():
                    with using(lib):
                        err = max((g - w).abs().max().item() for g, w in zip(fn(), want))
                        require(err <= 2e-5, f"attention {label} K={K} {n} warps: err {err}")
                        rows.append(f"{n} warps {fmt_ms(kernel_device_ms(fn, 'attn_'))}")
                print(f"sweep float32 attention {'backward' if bwd else 'forward'} {label} B={B} "
                      f"K={K} hd={hd}, within 2e-5, device time: " + ", ".join(rows))



def load_config():
    from pdanet_tpu_torch.config import cfg_from_yaml_file

    return cfg_from_yaml_file(str(YAML))


def serve(cfg, dev, parent=None):
    """Phase 4: serve three one-frame requests and one two-frame request
    through the serving closure.  With ``parent``, that tree's closure on
    the same weights answers the first request too, timed in turns beside
    this tree's, and each serving wrapper's host time a call is timed
    beside that tree's.  Returns the launch counts of that run, a copy of the
    model's seeded weights and the closure."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.ops import cuda_lib
    from pdanet_tpu_torch.serving import (example_device_batch, make_predict_fn,
                                          serving_input_spec)

    model = init_random_weights(
        build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev), seed=0)
    weights = copy.deepcopy(model.state_dict())
    predict = make_predict_fn(model, cfg.MODEL)
    for B in (1, 2):  # warm-up: allocator and library set-up per batch size
        predict(example_device_batch(cfg, serving_input_spec(cfg, B, model), dev))
    requests = [torch.from_numpy(lidar_like_cloud(100 + i, 1, N_POINTS)).to(dev)
                for i in range(3)]
    requests.append(torch.from_numpy(lidar_like_cloud(200, 2, N_POINTS)).to(dev))
    torch.cuda.synchronize()

    cuda_lib.launches.clear()
    results = []
    for pts in requests:
        t0 = time.perf_counter()
        res = predict({"points": pts})
        torch.cuda.synchronize()
        results.append((pts.shape[0], (time.perf_counter() - t0) * 1e3, res))
    launches = dict(cuda_lib.launches)

    for i, (B, ms, res) in enumerate(results):
        counts = res["pred_counts"]
        for key, val in res.items():
            require(tuple(val.shape[:1]) == (B,), f"request {i}: {key} batch shape")
            require(bool(torch.isfinite(val.float()).all()), f"request {i}: {key} not finite")
        require(bool(((counts >= 0) & (counts <= 500)).all()), f"request {i}: counts {counts}")
        print(f"request {i}: B={B} latency {ms:.2f} ms, detections {counts.tolist()}")
    print(f"kernel launches in the served requests: {launches}")
    print_split("a b1 request under torch.profiler",
                device_split(lambda: predict({"points": requests[0]})))
    for name in SERVE_KERNELS:
        require(launches.get(name, 0) > 0, f"kernel {name} never launched on the main path")
    if parent:
        vs_parent_request(parent, cfg, weights, predict, {"points": requests[0]}, dev)
        vs_parent_dispatch(parent, dev)
    return launches, weights, predict


def host_us(fn, reps=200, warmup=20):
    """Median host time of one call ``fn()`` in microseconds, the device
    still running (a synchronise every 20 calls keeps the queue short)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def vs_parent_dispatch(parent, dev):
    """The host time of one call of each serving wrapper, this tree's (a
    ``torch.library`` op) beside another tree's (``parent``), in turns a,
    b, b, a, at small shapes whose kernels take less than the call: in
    inference mode (serving) and in grad mode with the attention's inputs
    requiring their gradient (training).  Prints the difference summed over
    the 11 calls of a b1 request."""
    import torch

    from pdanet_tpu_torch.ops import attention, ball_query, nms, rotated_iou, sampling

    rs = np.random.RandomState(5)
    xyz = torch.tensor(rs.uniform(0, 4, (1, 256, 3)), dtype=torch.float32, device=dev)
    ctr = xyz[:, :64].contiguous()
    qkv = [torch.tensor(rs.randn(64 * 16, 64), dtype=torch.bfloat16, device=dev)
           for _ in range(3)]
    boxes = torch.from_numpy(random_boxes(5, 1, 64)).to(dev)
    iou = rotated_iou.boxes_iou_bev_batched_self(boxes)
    valid = torch.ones((1, 64), dtype=torch.bool, device=dev)
    calls = {  # name: (calls in a b1 request, the call of a tree's ops)
        "fps": (1, lambda ops: ops.sampling.farthest_point_sample(xyz, 64)),
        "ball_query": (4, lambda ops: ops.ball_query.ball_query_multi(
            [0.2, 0.4], [16, 32], xyz, ctr)),
        "attention": (4, lambda ops: ops.attention.neighbor_attention_flat(*qkv, 16, 1, 64)),
        "rotated_iou": (1, lambda ops: ops.rotated_iou.boxes_iou_bev_batched_self(boxes)),
        "nms": (1, lambda ops: ops.nms.greedy_nms_mask_batched(iou, valid, 0.1)),
    }
    trees = {"parent": parent, "this tree": types.SimpleNamespace(
        sampling=sampling, ball_query=ball_query, attention=attention,
        rotated_iou=rotated_iou, nms=nms)}
    for mode in ("inference", "grad"):
        extra = 0.0
        for name, (n, call) in calls.items():
            us = {}
            for tree in [*trees, *reversed(trees)]:
                with contextlib.ExitStack() as stack:
                    if mode == "inference":
                        stack.enter_context(torch.inference_mode())
                    elif name == "attention":
                        for t in qkv:
                            t.requires_grad_(True)
                        stack.callback(lambda: [t.requires_grad_(False) for t in qkv])
                    us.setdefault(tree, []).append(
                        host_us(lambda ops=trees[tree]: call(ops)))
            extra += n * (statistics.mean(us["this tree"]) - statistics.mean(us["parent"]))
            print(f"host time of one {name} call, {mode} mode: parent "
                  f"{' / '.join(f'{t:.1f}' for t in us['parent'])} us, this tree "
                  f"{' / '.join(f'{t:.1f}' for t in us['this tree'])} us (two turns)")
        print(f"{mode} mode: this tree's ops cost a b1 request's 11 calls {extra:+.1f} us of "
              f"host time against the parent's")


def vs_parent_request(parent, cfg, weights, predict, batch, dev):
    """The eager b1 request of another tree (``parent``) on the same
    weights, beside this tree's: its detections, and the latency and host
    enqueue time of both (``request_ms``), in eight turns a, b, b, a, ..."""
    import torch

    model = parent.models.build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev)
    model.load_state_dict(weights)
    fns = {"parent": parent.serving.make_predict_fn(model, cfg.MODEL), "this tree": predict}
    got, want = fns["parent"](batch), predict(batch)
    same = all(torch.equal(got[k], want[k]) for k in want)
    print(f"the parent tree's b1 request on the same weights: detections "
          f"{got['pred_counts'].tolist()}, {'bit for bit' if same else 'not equal to'} "
          f"this tree's")
    ms = {}
    for name in [*fns, *reversed(fns)] * 2:
        ms.setdefault(name, []).append(request_ms(fns[name], batch))
    for name, turns in ms.items():
        print(f"b1 request, {name}: median latency "
              f"{' / '.join(f'{lat:.2f}' for lat, _ in turns)} ms, host enqueue "
              f"{' / '.join(f'{enq:.2f}' for _, enq in turns)} ms over 20 after warm-up "
              f"(four turns)")


def match_detections(a, b):
    """Detections of one frame from two runs (``pred_*`` dicts at B = 1)
    paired by mutual nearest box among boxes of the same label, the
    distance taken over the whole box (centre, size, heading), so that two
    boxes of one label on one centre (the per-class NMS keeps a box in
    each class that scores it; two anchors of a location) pair with their
    own, and boxes that tie pair in turn among those left.  Returns (pairs,
    count in a, count in b, largest centre distance and largest score
    difference over the pairs)."""
    import torch

    def dets(r):
        n = int(r["pred_counts"][0])
        return (r["pred_boxes"][0, :n, :7].double().cpu(), r["pred_labels"][0, :n].cpu(),
                r["pred_scores"][0, :n].double().cpu())

    (ba, la, sa), (bb, lb, sb) = dets(a), dets(b)
    if not len(ba) or not len(bb):
        return 0, len(ba), len(bb), 0.0, 0.0
    d = torch.cdist(ba, bb)
    d[la[:, None] != lb[None, :]] = float("inf")
    near_b, near_a = d.argmin(1), d.argmin(0)
    pairs = [(i, int(j)) for i, j in enumerate(near_b)
             if torch.isfinite(d[i, j]) and int(near_a[j]) == i]
    # boxes that tie (equal boxes of one label) pair in turn among the rest
    used_a, used_b = {i for i, _ in pairs}, {j for _, j in pairs}
    for i in range(len(ba)):
        if i in used_a:
            continue
        rest = d[i].clone()
        rest[list(used_b)] = float("inf")
        j = int(rest.argmin())
        if torch.isfinite(rest[j]):
            pairs.append((i, j))
            used_b.add(j)
    gap_c = max(((ba[i, :3] - bb[j, :3]).norm().item() for i, j in pairs), default=0.0)
    gap_s = max(((sa[i] - sb[j]).abs().item() for i, j in pairs), default=0.0)
    return len(pairs), len(ba), len(bb), gap_c, gap_s


def compare_f32(cfg, weights, dev, predict_bf16):
    """Phase 5: one frame in float32 on the card (kernels) against the
    same weights on the CPU (plain versions, the reference); and a report
    (no gate) of the shipped bfloat16 serving closure's detections on the
    same frame against the float32 card run's."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors import get_post_processor

    mcfg = copy.deepcopy(cfg.MODEL)
    mcfg.BACKBONE_3D.pop("COMPUTE_DTYPE", None)
    mcfg.BACKBONE_3D.pop("TRAIN_COMPUTE_DTYPE", None)
    runs = {}
    frame = lidar_like_cloud(300, 1, N_POINTS)
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_network(mcfg, len(cfg.CLASS_NAMES), device=device)
        model.load_state_dict(weights)
        model.eval()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(torch.from_numpy(frame).to(device))
            post = get_post_processor(mcfg.NAME)(out, mcfg)
        print(f"float32 forward + NMS on the {name}: {time.perf_counter() - t0:.2f} s")
        runs[name] = (out, post)
    (g_out, g_post), (c_out, c_post) = runs["card"], runs["cpu"]

    sa_cfg = mcfg.BACKBONE_3D.SA_CONFIG
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        if "ctr_aware" in sa_cfg.SAMPLE_METHOD_LIST[k]:
            npoint = sa_cfg.NPOINT_LIST[k][0]
            sc = torch.sigmoid(c_out["sa_ins_preds"][k - 1].max(-1).values)
            sg = torch.sigmoid(g_out["sa_ins_preds"][k - 1].max(-1).values.cpu())
            srt = torch.sort(sc, dim=-1, descending=True).values
            print(f"SA{k} ctr-aware top-{npoint}: score gap at the cut "
                  f"{(srt[:, npoint - 1] - srt[:, npoint]).min().item():.3g}, "
                  f"max |card - cpu| score {(sg - sc).abs().max().item():.3g}")
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        if c_out["sampled_idx"][k] is not None:
            require(torch.equal(g_out["sampled_idx"][k].cpu(), c_out["sampled_idx"][k]),
                    f"SA{k} sampled indices differ card vs CPU")
        for r, (gb, cb) in enumerate(zip(g_out["ball_query_idx"][k] or (),
                                         c_out["ball_query_idx"][k] or ())):
            require(torch.equal(gb.cpu(), cb), f"SA{k} radius {r} ball query differs card vs CPU")
    err_f = (g_out["centers_features"].cpu() - c_out["centers_features"]).abs().max().item()
    err_c = (g_out["batch_cls_preds"].cpu() - c_out["batch_cls_preds"]).abs().max().item()
    err_b = (g_out["center_box_preds"].cpu() - c_out["center_box_preds"]).abs().max().item()
    print(f"float32 card vs CPU: indices equal; centers_features {err_f:.3g}, "
          f"cls logits {err_c:.3g}, box logits {err_b:.3g}; detections "
          f"{g_post['pred_counts'].tolist()} vs {c_post['pred_counts'].tolist()}")
    require(err_f <= 1e-3, f"centers_features err {err_f} > 1e-3")
    require(err_c <= 2e-3 and err_b <= 2e-3, f"logit errors {err_c}, {err_b} > 2e-3")
    require(torch.equal(g_post["pred_counts"].cpu(), c_post["pred_counts"]),
            "detection counts differ card vs CPU")

    # the shipped dtype: phase 4's bfloat16 closure on the same frame and
    # weights.  A report, not a gate: with seeded random weights no bar is
    # justified yet.
    bf = predict_bf16({"points": torch.from_numpy(frame).to(dev)})
    pairs, n_bf, n_f32, gap_c, gap_s = match_detections(bf, g_post)
    print(f"bfloat16 frame against the float32 frame on the card (report, no gate): "
          f"{n_bf} and {n_f32} detections, {pairs} paired by mutual nearest centre with the "
          f"same label ({100 * pairs / max(n_bf, n_f32, 1):.1f} % of the larger set); largest "
          f"centre distance {gap_c:.4g} m, largest score difference {gap_s:.4g}")


def check_attention_bwd(dev, stats, parent=None):
    """Phase 6: the attention backward kernels against the plain backward
    at the B = 4 training shapes and off the path, with SDPA's backward
    timed beside them; the attention op's gradient on the card against the
    plain backward.  ``parent``: another tree's wrappers, whose float32 backward
    is timed in turns beside this tree's at the B = 4 shapes."""
    import torch

    from pdanet_tpu_torch.ops import attention, cuda_lib

    gen = torch.Generator(device=dev).manual_seed(6)
    tols = {torch.float32: 2e-5, torch.bfloat16: 5e-2, torch.float64: 1e-12}
    cases = [(f"{label} B=4", 4 * M, K, hd, dt, True)
             for label, M, hd in ATTN_SHAPES
             for K in (16, 32) for dt in (torch.float32, torch.bfloat16)]
    cases += [("off-path", 64, K, hd, dt, False)
              for K, hd in ATTN_OFF_PATH for dt in (torch.float32, torch.bfloat16)]
    cases += [("SA1 B=4", 4 * 1024, 32, 64, torch.float64, False)]
    for label, centres, K, hd, dt, timed in cases:
        R, D = centres * K, 4 * hd
        name = "neighbor_attention_bwd_bf16" if dt == torch.bfloat16 else "neighbor_attention_bwd"
        st = stats[name]
        q, k, v, do = (torch.randn(R, D, generator=gen, device=dev).to(dt) for _ in range(4))
        got = attention.neighbor_attention_flat_bwd_cuda(q, k, v, do, K, 4, hd)
        want = attention.neighbor_attention_flat_bwd_plain(q, k, v, do, K, 4, hd)
        torch.cuda.synchronize()
        abs_err = max((g.double() - w.double()).abs().max().item() for g, w in zip(got, want))
        err, tol = grad_err(got, want, dt), tols[dt]
        what = "max err / max |grad|" if dt == torch.bfloat16 else "max abs err"
        require(all(g.dtype == dt for g in got) and err <= tol,
                f"attention backward {label} K={K} hd={hd} {dt}: {what} {err} > {tol}")
        st["max_abs_err"] = max(st["max_abs_err"], abs_err)
        line = f"{name:27s} {label} K={K} hd={hd} {str(dt)[6:]}: {what} {err:.3g}"
        if timed:
            lib_call = sdpa_backward(q, k, v, do, K, 4, hd)
            lib_err = grad_err(lib_call(), want, dt)
            require(lib_err <= tol, f"SDPA backward {label} K={K} hd={hd} {dt} differs from "
                    f"the plain backward: {lib_err} > {tol}")
            kern_ms, lib_ms = in_turns(
                lambda: attention.neighbor_attention_flat_bwd_cuda(q, k, v, do, K, 4, hd),
                lib_call)
            plain_ms = cuda_ms(lambda: attention.neighbor_attention_flat_bwd_plain(
                q, k, v, do, K, 4, hd))
            bnd = attention_bound(R, K, 4, hd, dt, bwd=True)
            line += (f" (SDPA {lib_err:.3g}); kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                     f"SDPA {lib_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), kernel at "
                     f"{100 * bnd[0] / kern_ms:.1f} % of it")
            if parent and dt == torch.float32:
                vs_parent(f"float32 attention backward {label} K={K} hd={hd}",
                          lambda: attention.neighbor_attention_flat_bwd_cuda(q, k, v, do, K, 4, hd),
                          lambda: parent.attention.neighbor_attention_flat_bwd_cuda(
                              q, k, v, do, K, 4, hd), device_name="attn_bwd_kernel")
            if label.startswith("SA1") and K == 32:
                st.update(ms=kern_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd[0],
                          bound_by=bnd[1])
                line += f"; SDPA backward ran {kernel_names(lib_call)}"
            del lib_call
        print(line)
        del q, k, v, do, got, want

    # the attention op's gradient on the card: its backward is the kernel of
    # the input's dtype
    K, hd = 32, 64
    for dt, name in ((torch.float32, "neighbor_attention_bwd"),
                     (torch.bfloat16, "neighbor_attention_bwd_bf16")):
        q, k, v, do = (torch.randn(64 * K, 4 * hd, generator=gen, device=dev).to(dt)
                       for _ in range(4))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = cuda_lib.launches[name]
        attention.neighbor_attention_flat(*leaves, K, 4, hd).backward(do)
        torch.cuda.synchronize()
        require(cuda_lib.launches[name] == before + 1,
                f"the attention op's gradient did not launch {name}")
        want = attention.neighbor_attention_flat_bwd_plain(q, k, v, do, K, 4, hd)
        err = grad_err([t.grad for t in leaves], want, dt)
        require(err <= tols[dt], f"attention op's gradient on the card, {dt}: grad err "
                f"{err} > {tols[dt]}")
        print(f"attention op's gradient on the card ({str(dt)[6:]}, K={K}, hd={hd}): grads "
              f"within {err:.3g} of the plain backward, through {name}")

    # gradcheck of the op on the card, float64 (the SIMT kernels)
    K, H, hd = 8, 2, 16
    leaves = [torch.randn(3 * K, H * hd, generator=gen, device=dev, dtype=torch.float64)
              .requires_grad_() for _ in range(3)]
    before = cuda_lib.launches["neighbor_attention_bwd"]
    torch.autograd.gradcheck(
        lambda a, b, c: attention.attention_op(a, b, c, K, H, hd), leaves)
    require(cuda_lib.launches["neighbor_attention_bwd"] > before,
            "gradcheck did not go through the backward kernel")
    print(f"torch.autograd.gradcheck of the attention op on the card (float64, K={K}, "
          f"hd={hd}): passed")


def _train_model(cfg, mcfg, weights, dev, train_frames=3712):
    """The model on ``dev`` with ``weights`` and its train step, on the
    yaml's schedule over ``train_frames`` frames an epoch (KITTI's train
    split by default)."""
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.train import build_optimizer_and_schedule, make_train_step

    model = build_network(mcfg, len(cfg.CLASS_NAMES), device=dev)
    model.load_state_dict(weights)
    ocfg = cfg.OPTIMIZATION
    optimizer, schedule = build_optimizer_and_schedule(
        model, ocfg, total_iters_each_epoch=train_frames // ocfg.BATCH_SIZE_PER_GPU,
        total_epochs=ocfg.NUM_EPOCHS)
    return model, make_train_step(model, optimizer, schedule)


def _grads_finite(model):
    import torch

    flags = [torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None]
    return bool(torch.stack(flags).all())


def train(cfg, weights, dev):
    """Phase 7: 5 full-width train steps at B = 4 in bfloat16 compute and
    3 in float32.  Returns the launch counts of each, counted from 0."""
    import torch

    from pdanet_tpu_torch.ops import cuda_lib

    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    mean_size = np.asarray(cfg.MODEL.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size,
                           np.float32)
    pts, gt = lidar_like_batch(400, B, N_POINTS, mean_size)
    batch = {"points": torch.from_numpy(pts).to(dev), "gt_boxes": torch.from_numpy(gt).to(dev)}
    f32_cfg = copy.deepcopy(cfg.MODEL)
    f32_cfg.BACKBONE_3D.pop("COMPUTE_DTYPE", None)
    f32_cfg.BACKBONE_3D.pop("TRAIN_COMPUTE_DTYPE", None)
    launches = {}
    for name, mcfg, n_steps in (("bf16", cfg.MODEL, 5), ("f32", f32_cfg, 3)):
        model, train_step = _train_model(cfg, mcfg, weights, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_lib.launches.clear()
        times, losses = [], []
        for i in range(n_steps):
            t0 = time.perf_counter()
            loss, tb = train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            require(np.isfinite(losses[-1]), f"{name} step {i}: loss {losses[-1]}")
            require(_grads_finite(model), f"{name} step {i}: gradients not finite")
        counts = dict(cuda_lib.launches)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print_split(f"a {name} train step under torch.profiler",
                    device_split(lambda: train_step(batch)))
        print(f"train {name} B={B}: losses {[round(x, 4) for x in losses]}; ms/step "
              f"{[round(t, 2) for t in times]}, median after warm-up "
              f"{statistics.median(times[1:]):.2f} ms; peak memory {peak:.2f} GiB")
        print(f"train {name} B={B}: tb of the last step "
              f"{ {k: round(float(v), 4) for k, v in tb.items()} }")
        print(f"kernel launches in the {name} train steps: {counts}")
        for kname in TRAIN_KERNELS[name]:
            require(counts.get(kname, 0) > 0, f"kernel {kname} never launched in {name} training")
        launches[name] = counts
        del model, train_step
    return launches


def _leaf_errors(got, want, floor):
    """Per gradient leaf, max |got - want| over the leaf's scale: its
    largest |want|, floored at ``floor`` times the largest |want| of any
    leaf.  Below that floor a gradient is rounding noise: the key
    projection's bias, the DensityNet's conv biases and the transformer's
    linear2 bias have a zero true gradient (a softmax row ignores a
    shift; a training-mode BatchNorm follows the others), measured at
    1e-15 to 1e-13 in float64 against 62 for the largest leaf, and at
    1e-7 to 1e-4 in float32."""
    top = floor * max(w.abs().max().item() for w in want.values())
    errs = sorted(((got[n] - w).abs().max().item() / max(w.abs().max().item(), top), n)
                  for n, w in want.items())
    return errs[::-1]


def _deciles(errs):
    vals = sorted(e for e, _ in errs)
    return [f"{vals[int(q * (len(vals) - 1))]:.2g}" for q in np.linspace(0, 1, 11)]


@contextlib.contextmanager
def fed(sampling=None, ball_query=None):
    """Replace the backbone's sampling and ball query for one run."""
    from pdanet_tpu_torch.models.backbones_3d import iassd_backbone

    own = iassd_backbone.run_sampling, iassd_backbone.ball_query_multi
    if sampling is not None:
        iassd_backbone.run_sampling = sampling
    if ball_query is not None:
        iassd_backbone.ball_query_multi = ball_query
    try:
        yield
    finally:
        iassd_backbone.run_sampling, iassd_backbone.ball_query_multi = own


def card_ctr_picks(queue, checks):
    """A sampling function for a CPU run that replays a card run's picks
    (``queue``, in call order): the CPU's own D-FPS picks, and the card's
    ctr-aware picks.  It appends to ``checks`` per layer (kind, indices
    where the CPU's own picks differ from the card's, largest difference
    of the CPU scores of the two picks position by position)."""
    import torch

    from pdanet_tpu_torch.models.backbones_3d import iassd_backbone

    own_sampling = iassd_backbone.run_sampling

    def pick(types, ranges, npoints, xyz, features, cls_features):
        own, card = own_sampling(types, ranges, npoints, xyz, features, cls_features), queue.pop(0)
        if not any("ctr" in t or "cls" in t for t in types):
            checks.append(("D-FPS", int((own != card).sum()), 0.0))
            return own
        score = torch.sigmoid(cls_features.detach().max(dim=-1).values)
        gap = (score.gather(1, card.long()) - score.gather(1, own.long())).abs().max().item()
        checks.append(("ctr-aware", int((own != card).sum()), gap))
        return card

    return pick


def feed_all(picks, recorded):
    """``fed`` arguments that replay sampling picks and a recorded run's
    ball-query indices, in call order, on the device of each call."""
    samp = list(picks)
    ball = [b for b in recorded["out"]["ball_query_idx"] if b is not None]
    return dict(sampling=lambda *a: samp.pop(0).to(a[3].device),
                ball_query=lambda r, n, xyz, c: tuple(t.to(xyz.device) for t in ball.pop(0)))


def _recorded_step(cfg, mcfg, weights, device, dtype, pts, gt, train_frames=3712):
    """One train step from ``weights`` on ``device`` in ``dtype``: its loss,
    forward dict, gradients, BatchNorm statistics and parameters after the
    update (on the CPU, float64)."""
    import torch

    model, train_step = _train_model(cfg, mcfg, weights, device, train_frames)
    model.to(dtype)
    captured = {}
    hook = model.register_forward_hook(lambda m, i, o: captured.update(o))
    t0 = time.perf_counter()
    loss, _ = train_step({"points": torch.as_tensor(pts).to(device, dtype),
                          "gt_boxes": torch.as_tensor(gt).to(device, dtype)})
    loss = loss.item()
    hook.remove()
    print(f"{str(dtype)[6:]} train step B={pts.shape[0]} on the {device.type}: "
          f"{time.perf_counter() - t0:.2f} s, loss {loss!r}")
    return dict(
        loss=loss, out=captured, fps_identity=model.backbone_3d.fps_identity,
        grads={n: p.grad.detach().double().cpu() for n, p in model.named_parameters()},
        stats={n: b.detach().double().cpu() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var"))},
        params={n: p.detach().double().cpu() for n, p in model.named_parameters()})


def compare_train(cfg, weights, dev):
    """Phase 7, second part: one train step at B = 1 on the card (kernels)
    against the CPU (plain versions), in float32 and in float64; and the
    max-pool tie routing on the card."""
    import torch

    from pdanet_tpu_torch.ops.grouping import group_points

    mcfg = copy.deepcopy(cfg.MODEL)
    mcfg.BACKBONE_3D.pop("COMPUTE_DTYPE", None)
    mcfg.BACKBONE_3D.pop("TRAIN_COMPUTE_DTYPE", None)
    mean_size = np.asarray(mcfg.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size,
                           np.float32)
    sa_cfg = mcfg.BACKBONE_3D.SA_CONFIG
    pts, gt = lidar_like_batch(500, 1, N_POINTS, mean_size)

    def run(device, dtype):
        return _recorded_step(cfg, mcfg, weights, device, dtype, pts, gt)

    cpu = torch.device("cpu")
    card32 = run(dev, torch.float32)
    card_picks = [i.cpu() for k, i in enumerate(card32["out"]["sampled_idx"])
                  if i is not None and not card32["fps_identity"][k]]

    # float32.  The ctr-aware sampling sorts scores that the card and the
    # CPU compute to within ~1e-6 (float32 sums in another order): two
    # scores that close may swap, and the order of every later layer
    # follows (at full width a frame's top-k scores are seldom all 5e-6
    # apart).  So the CPU run takes the card's ctr-aware picks, after
    # checking them against its own: position by position, the CPU scores
    # of the two picks must agree within 1e-5.  D-FPS picks are the CPU's
    # own and must be equal.
    queue, checks = list(card_picks), []
    with fed(sampling=card_ctr_picks(queue, checks)):
        cpu32 = run(cpu, torch.float32)
    require(not queue, "the CPU run did not sample every layer")
    for what, n_diff, gap in checks:
        print(f"train {what} sampling, CPU's own against the card's: {n_diff} indices "
              f"differ, largest CPU-score difference of the picks {gap:.3g}")
        require((what == "D-FPS" and n_diff == 0) or (what == "ctr-aware" and gap <= 1e-5),
                f"train {what} sampling differs card vs CPU beyond near ties")
    for k in range(len(sa_cfg.NSAMPLE_LIST)):
        for r, (gb, cb) in enumerate(zip(card32["out"]["ball_query_idx"][k] or (),
                                         cpu32["out"]["ball_query_idx"][k] or ())):
            require(torch.equal(gb.cpu(), cb), f"train SA{k} radius {r} ball query differs")
    rel32 = abs(card32["loss"] - cpu32["loss"]) / abs(cpu32["loss"])
    require(rel32 <= 1e-4, f"float32 train loss card vs CPU: rel {rel32} > 1e-4")
    for n, cs in cpu32["stats"].items():
        err = (card32["stats"][n] - cs).abs().max().item()
        require(err <= 1e-5 * max(cs.abs().max().item(), 1.0),
                f"float32 BN statistic {n}: err {err} > 1e-5 of max(|stat|, 1)")
    errs32 = _leaf_errors(card32["grads"], cpu32["grads"], 1e-3)

    # float64: the same step with every sampling and ball-query index fed
    # from the float32 card run, on the card (the attention kernels in
    # float64) and on the CPU.  float32 gradients of one step are chaotic
    # at the 1e-3 level on either device (a max-pool or ReLU decision on a
    # near tie routes a gradient elsewhere; tests/test_train_trajectory_
    # twin.py:47-59); in float64 the two must agree to rounding.
    with fed(**feed_all(card_picks, card32)):
        card64 = run(dev, torch.float64)
    with fed(**feed_all(card_picks, card32)):
        cpu64 = run(cpu, torch.float64)
    rel64 = abs(card64["loss"] - cpu64["loss"]) / abs(cpu64["loss"])
    errs64 = _leaf_errors(card64["grads"], cpu64["grads"], 1e-6)
    err_stats64 = max((card64["stats"][n] - cs).abs().max().item()
                      / max(cs.abs().max().item(), 1.0) for n, cs in cpu64["stats"].items())
    errs32_64 = _leaf_errors(card32["grads"], cpu64["grads"], 1e-3)
    errs_cpu32_64 = _leaf_errors(cpu32["grads"], cpu64["grads"], 1e-3)
    print(f"train step card vs CPU over {len(errs32)} gradient leaves (err / leaf scale): "
          f"float32 largest {errs32[0][0]:.3g} ({errs32[0][1]}), deciles {_deciles(errs32)}; "
          f"float64 largest {errs64[0][0]:.3g} ({errs64[0][1]}), deciles {_deciles(errs64)}")
    print(f"float32 against the float64 CPU step, deciles: card {_deciles(errs32_64)}, "
          f"CPU {_deciles(errs_cpu32_64)}")
    print(f"train step card vs CPU: loss rel float32 {rel32:.3g}, float64 {rel64:.3g}; "
          f"{len(cpu32['stats'])} BN statistics, float64 largest err {err_stats64:.3g}")
    require(rel64 <= 1e-10, f"float64 train loss card vs CPU: rel {rel64} > 1e-10")
    require(errs64[0][0] <= 1e-3, f"float64 gradient {errs64[0][1]}: {errs64[0][0]} > 1e-3")
    require(err_stats64 <= 1e-5, f"float64 BN statistics: err {err_stats64} > 1e-5")
    require(errs32[0][0] <= 1e-1, f"float32 gradient {errs32[0][1]}: {errs32[0][0]} > 1e-1")

    # tie routing: SA0's ball query pads each group with its first hit, so
    # the grouped features carry exact ties; the gradient of
    # Tensor.max(dim).values must go to the first tied slot only
    idx = card32["out"]["ball_query_idx"][0][1]  # (1, 4096, 32)
    feats = torch.randn(1, N_POINTS, 64, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    grouped = group_points(feats, idx).requires_grad_()
    grouped.max(dim=2).values.sum().backward()
    top = grouped.detach().max(dim=2, keepdim=True).values
    is_max = grouped.detach() == top
    first = torch.argmax(is_max.to(torch.uint8), dim=2, keepdim=True)
    want = torch.zeros_like(grouped).scatter_(2, first, 1.0)
    ties = int((is_max.sum(dim=2) > 1).sum())
    require(ties > 0, "no tied slots to check the max-pool gradient on")
    require(torch.equal(grouped.grad, want),
            "max-pool gradient on the card does not go to the first tied slot")
    print(f"max-pool tie routing on the card: {ties} (centre, channel) pairs with tied "
          f"slots, every gradient on the first")


# ---------------------------------------------------------------------------
# phase 8: the ONCE configuration end to end
# ---------------------------------------------------------------------------

ONCE_YAML = ROOT / "tools" / "cfgs" / "once_models" / "PDA-SSD.yaml"
ONCE_FRAME_POINTS = 70000  # raw returns a frame; the yaml samples 60000
ONCE_CAMS = ("cam01", "cam03", "cam05", "cam06", "cam07", "cam08", "cam09")
ONCE_SPLITS = (("train", "000001", 6), ("val", "000002", 2))  # split, sequence, frames


def once_like_frame(rs, class_names, mean_sizes, n_points=ONCE_FRAME_POINTS, extent=75.2):
    """One roof-LiDAR-like frame over ONCE's range: 20-40 boxes of the five
    classes at the yaml's mean sizes (10 % jitter), apart in BEV, on the
    ground at z -1.8 m, each holding returns (more the nearer it is); a
    ground disc with the 1/r density of a spinning sensor; sparse returns
    in the air.  Returns (points (n, 4) float32 with intensity 0-255,
    boxes (m, 7), names (m,))."""
    boxes, names = [], []
    while len(boxes) < rs.randint(20, 41):
        cls = rs.randint(len(class_names))
        dims = np.asarray(mean_sizes[cls]) * rs.uniform(0.9, 1.1, 3)
        r, th = rs.uniform(4.0, 68.0), rs.uniform(-np.pi, np.pi)
        box = np.array([r * np.cos(th), r * np.sin(th), -1.8 + dims[2] / 2, *dims,
                        rs.uniform(-np.pi, np.pi)])
        radius = 0.5 * np.hypot(dims[0], dims[1])
        if all(np.hypot(*(box[:2] - b[:2])) > radius + 0.5 * np.hypot(b[3], b[4]) + 0.3
               for b in boxes):
            boxes.append(box)
            names.append(class_names[cls])
    boxes = np.stack(boxes)
    n_obj, n_air = int(n_points * 0.2), int(n_points * 0.05)
    n_ground = n_points - n_obj - n_air
    share = 1.0 / np.hypot(boxes[:, 0], boxes[:, 1])
    per_box = np.maximum(20, (n_obj * share / share.sum()).astype(int))
    obj = []
    for b, n in zip(boxes, per_box):
        local = (rs.rand(n, 3) - 0.5) * b[3:6] * 0.95
        c, s = np.cos(b[6]), np.sin(b[6])
        obj.append(np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                             local[:, 0] * s + local[:, 1] * c + b[1],
                             local[:, 2] + b[2]], -1))
    r = 2.0 + (extent - 2.0) * rs.rand(n_ground) ** 1.6
    th = rs.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th), rs.normal(-1.8, 0.05, n_ground)], -1)
    air = np.stack([rs.uniform(-extent, extent, n_air), rs.uniform(-extent, extent, n_air),
                    rs.uniform(-1.5, 3.0, n_air)], -1)
    xyz = np.concatenate([ground, air] + obj)
    xyz[:, :2] = np.clip(xyz[:, :2], -extent, extent)
    pts = np.concatenate([xyz, rs.uniform(0, 255, (len(xyz), 1))], -1).astype(np.float32)
    return pts[rs.permutation(len(pts))], boxes, np.array(names)


def write_once_root(root, class_names, mean_sizes, seed=0):
    """A synthetic ONCE root in the layout of ``tests/once_fixture.py``
    (``data/<seq>/<seq>.json``, ``data/<seq>/lidar_roof/<frame>.bin``,
    ``ImageSets/<split>.txt``): one sequence of train frames and one of
    val frames (the test split lists the val sequence), ``once_like_frame``
    clouds.  Returns the number of frames and boxes per split."""
    import json

    rs = np.random.RandomState(seed)
    cam_to_velo = np.eye(4)
    cam_to_velo[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    calib = {c: {"cam_to_velo": cam_to_velo.tolist(),
                 "cam_intrinsic": [[1000, 0, 960], [0, 1000, 540], [0, 0, 1]],
                 "distortion": [0] * 5} for c in ONCE_CAMS}
    (root / "ImageSets").mkdir(parents=True)
    counts = {}
    for split, seq, n_frames in ONCE_SPLITS:
        seq_dir = root / "data" / seq
        (seq_dir / "lidar_roof").mkdir(parents=True)
        frames = []
        for f in range(n_frames):
            fid = str(1616100000000 + 1000 * int(seq) + f)
            pts, boxes, names = once_like_frame(rs, class_names, mean_sizes)
            pts.tofile(seq_dir / "lidar_roof" / f"{fid}.bin")
            frames.append({"frame_id": fid, "pose": [0, 0, 0, 1, 0, 0, 0], "annos": {
                "names": names.tolist(), "boxes_3d": boxes.tolist(),
                "boxes_2d": {c: [[-1, -1, -1, -1]] * len(boxes) for c in ONCE_CAMS}}})
        with open(seq_dir / f"{seq}.json", "w") as fh:
            json.dump({"meta_info": {"weather": "sunny", "period": "morning"},
                       "calib": calib, "frames": frames}, fh)
        (root / "ImageSets" / f"{split}.txt").write_text(seq + "\n")
        counts[split] = (n_frames, sum(len(fr["annos"]["names"]) for fr in frames))
    (root / "ImageSets" / "test.txt").write_text(ONCE_SPLITS[1][1] + "\n")
    return counts


def once_expected_keys(thresh_list):
    """The keys of the JAX package's ONCE ``eval_one_epoch`` result: recall
    per threshold, then AP per superclass and distance bin."""
    keys = [f"recall/{k}_{t}" for t in thresh_list for k in ("roi", "rcnn")]
    return keys + [f"AP_{c}/{d}" for c in ("Vehicle", "Pedestrian", "Cyclist", "mean")
                   for d in ("overall", "0-30m", "30-50m", "50m-inf")]


def once_phase(dev, work_dir):
    """Phase 8: the ONCE configuration (tools/cfgs/once_models/PDA-SSD.yaml)
    end to end at full width.  Returns the kernel launches of its main-path
    runs (the train steps and ``eval_one_epoch``, each counted from 0)."""
    import collections
    import logging

    import torch

    from pdanet_tpu_torch.config import cfg_from_yaml_file
    from pdanet_tpu_torch.datasets import build_dataloader
    from pdanet_tpu_torch.datasets.once.once_dataset import create_once_infos
    from pdanet_tpu_torch.eval import eval_one_epoch
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.models.detectors.iassd import generate_recall_record
    from pdanet_tpu_torch.ops import ball_query, cuda_lib, sampling
    from pdanet_tpu_torch.serving import make_predict_fn
    from pdanet_tpu_torch.train import select_device_batch

    cfg = cfg_from_yaml_file(str(ONCE_YAML))
    root = Path(work_dir) / "once"
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    names = list(cfg.CLASS_NAMES)
    mean_sizes = cfg.MODEL.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size
    n_sample = cfg.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS

    # ---- data: the root, infos, gt database and loaders
    t0 = time.perf_counter()
    counts = write_once_root(root, names, mean_sizes)
    create_once_infos(cfg.DATA_CONFIG, names, root, root, workers=4)
    print(f"ONCE data: synthetic root {counts} (frames, boxes) of {ONCE_FRAME_POINTS} points, "
          f"infos and gt database in {time.perf_counter() - t0:.1f} s")
    np.random.seed(0)
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    train_set, train_loader, _ = build_dataloader(cfg.DATA_CONFIG, names, B, root_path=root,
                                                  workers=4, seed=0, training=True)
    batches, data_ms, epoch = [], [], 0
    while len(batches) < 5:
        train_loader.set_epoch(epoch)
        it, epoch = iter(train_loader), epoch + 1
        while len(batches) < 5:
            t1 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            data_ms.append((time.perf_counter() - t1) * 1e3)
            batches.append(batch)
    for batch in batches:
        require(batch["points"].shape == (B, n_sample["train"], 4), "ONCE train batch points")
        require(batch["gt_boxes"].shape == (B, cfg.DATA_CONFIG.MAX_GT_BOXES, 8),
                "ONCE train batch gt")
    n_gt = [int((b["gt_boxes"][..., 7] > 0).sum()) for b in batches]
    print(f"ONCE loader (gt sampling, flip, rotation, scaling; mask, sample "
          f"{n_sample['train']}, shuffle, sort): {len(batches)} batches of {B}, gt boxes per "
          f"batch {n_gt}, host ms per batch {[round(t) for t in data_ms]}")

    # ---- train: 5 bfloat16 steps (as shipped) at B = 2, then 2 float32 steps
    t0 = time.perf_counter()
    model = init_random_weights(build_network(cfg.MODEL, len(names), device=dev), seed=0)
    weights = copy.deepcopy(model.state_dict())
    del model
    f32_cfg = copy.deepcopy(cfg.MODEL)
    f32_cfg.BACKBONE_3D.pop("COMPUTE_DTYPE", None)
    f32_cfg.BACKBONE_3D.pop("TRAIN_COMPUTE_DTYPE", None)
    dev_batches = [select_device_batch(b, dev) for b in batches]
    launches, bf16_model = collections.Counter(), None
    for name, mcfg, n_steps in (("bf16", cfg.MODEL, 5), ("f32", f32_cfg, 2)):
        model, train_step = _train_model(cfg, mcfg, weights, dev, len(train_set))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_lib.launches.clear()
        times, losses = [], []
        for i in range(n_steps):
            t1 = time.perf_counter()
            loss, tb = train_step(dev_batches[i])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            losses.append(loss.item())
            require(np.isfinite(losses[-1]), f"ONCE {name} step {i}: loss {losses[-1]}")
            require(_grads_finite(model), f"ONCE {name} step {i}: gradients not finite")
        counts = dict(cuda_lib.launches)
        launches.update(counts)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        print_split(f"a ONCE {name} train step B={B} under torch.profiler",
                    device_split(lambda: train_step(dev_batches[0])))
        print(f"ONCE train {name} B={B}: losses {[round(x, 4) for x in losses]}; ms/step "
              f"{[round(t, 2) for t in times]}, median after warm-up "
              f"{statistics.median(times[1:]):.2f} ms; peak memory {peak:.2f} GiB; vote loss "
              f"(ver2) of the last step {float(tb['vote_loss']):.4f}")
        print(f"kernel launches in the ONCE {name} train steps: {counts}")
        for kname in TRAIN_KERNELS[name]:
            require(counts.get(kname, 0) > 0, f"kernel {kname} never launched in ONCE {name} "
                    f"training")
        if name == "bf16":
            bf16_model = model
        del train_step
    print(f"ONCE training: {time.perf_counter() - t0:.1f} s")

    # ---- eval_one_epoch on the val split at B = 1, bfloat16 compute as shipped
    t0 = time.perf_counter()
    np.random.seed(1)
    val_set, val_loader, _ = build_dataloader(cfg.DATA_CONFIG, names, 1, root_path=root,
                                              workers=0, training=False)
    logger = logging.getLogger("chip_smoke.once")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler(sys.stdout))
    cuda_lib.launches.clear()
    result = eval_one_epoch(cfg, bf16_model, val_loader, 0, logger,
                            result_dir=Path(work_dir) / "once_eval", infer_time=True,
                            device=dev)
    counts = dict(cuda_lib.launches)
    launches.update(counts)
    print(f"kernel launches in ONCE eval_one_epoch: {counts}")
    for kname in SERVE_KERNELS:
        require(counts.get(kname, 0) > 0, f"kernel {kname} never launched in ONCE eval")
    keys = once_expected_keys(cfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST)
    require(list(result) == keys, f"ONCE result keys {list(result)} != {keys}")
    require(all(np.isfinite(float(v)) for v in result.values()), "ONCE result not finite")
    print("ONCE eval_one_epoch result (random weights): "
          + json.dumps({k: float(v) for k, v in result.items()}))
    print(f"ONCE eval_one_epoch over {len(val_set)} val frames: {time.perf_counter() - t0:.1f} s")

    # one ONCE b1 request: latency and device split
    predict = make_predict_fn(bf16_model, cfg.MODEL)
    np.random.seed(2)
    frame = next(iter(val_loader))
    request = {"points": torch.as_tensor(frame["points"]).to(dev)}
    lat = []
    for _ in range(4):
        t1 = time.perf_counter()
        res = predict(request)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    print(f"ONCE b1 request ({request['points'].shape[1]} points): latency ms "
          f"{[round(t, 2) for t in lat]} (first is warm-up), detections "
          f"{res['pred_counts'].tolist()}")
    print_split("a ONCE b1 request under torch.profiler", device_split(lambda: predict(request)))
    # eval_one_epoch's per-frame extra: the recall record on the device
    gt = torch.as_tensor(frame["gt_boxes"]).to(dev)
    valid = torch.arange(res["pred_boxes"].shape[1], device=dev)[None] < res["pred_counts"][:, None]
    rec_ms = []
    for _ in range(4):
        t1 = time.perf_counter()
        with torch.inference_mode():
            generate_recall_record(res["pred_boxes"], valid, gt,
                                   cfg.MODEL.POST_PROCESSING.RECALL_THRESH_LIST)
        torch.cuda.synchronize()
        rec_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"ONCE recall record of one frame ({res['pred_boxes'].shape[1]} boxes x "
          f"{gt.shape[1]} gt rows, plain boxes_iou3d): ms {[round(t, 2) for t in rec_ms]}")
    del bf16_model, predict

    # ---- the SA0 ball query at ONCE scale against its plain version
    sa_cfg = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    M = sa_cfg.NPOINT_LIST[0][0]
    sup = request["points"][..., :3].contiguous()
    ctr = torch.gather(sup, 1, sampling.farthest_point_sample_cuda(sup, M).long()
                       [..., None].expand(1, M, 3)).contiguous()
    radii, ks = tuple(sa_cfg.RADIUS_LIST[0]), tuple(sa_cfg.NSAMPLE_LIST[0])
    got = ball_query.ball_query_multi_cuda(radii, ks, sup, ctr)
    want = ball_query.ball_query_multi_plain(radii, ks, sup, ctr)
    for g, w in zip(got, want):
        require(torch.equal(g, w), f"ONCE SA0 ball query K={w.shape[-1]} differs from the "
                f"plain version")
    ms = cuda_ms(lambda: ball_query.ball_query_multi_cuda(radii, ks, sup, ctr))
    plain_ms = cuda_ms(lambda: ball_query.ball_query_multi_plain(radii, ks, sup, ctr), reps=3,
                       warmup=1)
    print(f"{'ball_query':27s} ONCE SA0 N={sup.shape[1]} M={M} radii {radii} K {ks} equal: "
          f"{ms:.4f} ms (plain {plain_ms:.4f} ms) under CUDA events")
    print_ball_query_work(f"ONCE SA0 B=1 N={sup.shape[1]} M={M}", radii, ks, sup, ctr)
    del got, want

    # ---- one float64 ONCE train step (ver2), card against CPU, every index fed
    first = batches[0]
    compare_once_f64(cfg, f32_cfg, weights, dev, first["points"][:1], first["gt_boxes"][:1],
                     len(train_set))
    return launches


def compare_once_f64(cfg, mcfg, weights, dev, pts, gt, train_frames):
    """One ONCE train step (ver2 vote loss) at B = 1 in float64 on the card
    and on the CPU, every sampling and ball-query index fed from a float32
    card step: loss within 1e-9 relative, every gradient leaf within 1e-3 of
    its scale (floored at 1e-6 of the largest leaf's), BatchNorm statistics
    within 1e-5.  The card's ``index_add_`` sums in atomic order, so the
    two agree to rounding, not bit for bit."""
    import torch

    card32 = _recorded_step(cfg, mcfg, weights, dev, torch.float32, pts, gt, train_frames)
    picks = [i.cpu() for k, i in enumerate(card32["out"]["sampled_idx"])
             if i is not None and not card32["fps_identity"][k]]
    runs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        with fed(**feed_all(picks, card32)):
            runs[name] = _recorded_step(cfg, mcfg, weights, device, torch.float64, pts, gt,
                                        train_frames)
    card64, cpu64 = runs["card"], runs["cpu"]
    rel = abs(card64["loss"] - cpu64["loss"]) / abs(cpu64["loss"])
    errs = _leaf_errors(card64["grads"], cpu64["grads"], 1e-6)
    err_stats = max((card64["stats"][n] - cs).abs().max().item() / max(cs.abs().max().item(), 1.0)
                    for n, cs in cpu64["stats"].items())
    top = max(w.abs().max().item() for w in cpu64["grads"].values())
    worst = cpu64["grads"][errs[0][1]].abs().max().item()
    print(f"ONCE float64 train step card vs CPU (indices fed): loss rel {rel:.3g}; over "
          f"{len(errs)} gradient leaves largest {errs[0][0]:.3g} ({errs[0][1]}, whose largest "
          f"|gradient| is {worst / top:.3g} of the largest leaf's), deciles {_deciles(errs)}; "
          f"BN statistics largest {err_stats:.3g}")
    require(rel <= 1e-9, f"ONCE float64 train loss card vs CPU: rel {rel} > 1e-9")
    require(errs[0][0] <= 1e-3, f"ONCE float64 gradient {errs[0][1]}: {errs[0][0]} > 1e-3")
    require(err_stats <= 1e-5, f"ONCE float64 BN statistics: err {err_stats} > 1e-5")


# ---------------------------------------------------------------------------
# phase 9: KITTI through the CLIs
# ---------------------------------------------------------------------------

CFGS = ROOT / "tools" / "cfgs"  # the shipped yamls, linked into phase 9's working directory
KITTI_CFG_REL = "cfgs/kitti_models/PDA-SSD.yaml"  # as a user runs it from tools/
KITTI_FRAME_POINTS = 120000  # returns of a 360-degree sweep; the FOV keeps about a fifth
KITTI_SPLITS = (("train", 32), ("val", 4))  # 32 train frames: 8 steps at B = 4
KITTI_IMAGE = (1242, 375)  # width, height
KITTI_TRAIN_KERNELS = ("fps", "ball_query", "neighbor_attention_bf16",
                       "neighbor_attention_bwd_bf16", "rotated_iou", "nms")
# the calib and plane files of tests/kitti_fixture.py (the devkit's sample, rounded)
KITTI_CALIB = """P0: 707.0493 0 604.0814 0 0 707.0493 180.5066 0 0 0 1 0
P1: 707.0493 0 604.0814 -379.7842 0 707.0493 180.5066 0 0 0 1 0
P2: 707.0493 0 604.0814 45.75831 0 707.0493 180.5066 -0.3454157 0 0 1 0.004981016
P3: 707.0493 0 604.0814 -334.1081 0 707.0493 180.5066 2.33966 0 0 1 0.003201153
R0_rect: 0.9999128 0.01009263 -0.008511932 -0.01012729 0.9999406 -0.004037671 0.008470675 0.004123522 0.9999556
Tr_velo_to_cam: 0.006927964 -0.9999722 -0.002757829 -0.02457729 -0.001162982 0.002749836 -0.9999955 -0.06127237 0.9999753 0.006931141 0.001143899 -0.3321029
Tr_imu_to_velo: 0.9999976 0.0007553071 -0.002035826 -0.8086759 -0.0007854027 0.9998898 -0.01482298 0.3195559 0.002024406 0.01482454 0.9998881 -0.7997231
"""
KITTI_PLANE = """# Plane
Width 4
Height 1
-1.855735e-02 -9.998253e-01 -1.616003e-03 1.640574e+00
"""
KITTI_DONTCARE = "DontCare -1 -1 -10 500.00 170.00 590.00 190.00 -1 -1 -1 -1000 -1000 -1000 -10"


def kitti_like_frame(rs, class_names, mean_sizes, n_points=KITTI_FRAME_POINTS, extent=80.0):
    """One 360-degree LiDAR-like frame with the sensor 1.73 m above the
    ground: 10-20 boxes of the three classes at the yaml's mean sizes (10 %
    jitter), apart in BEV, on the ground inside the camera's field of view
    (within 35 degrees of the x axis, 5-55 m out), each holding returns
    (more the nearer it is); a ground disc with the falling density of a
    spinning sensor; sparse returns in the air.  Returns (points (n, 4)
    float32 with intensity in [0, 1), boxes (m, 7) in the lidar frame,
    names (m,))."""
    boxes, names = [], []
    n_boxes = rs.randint(10, 21)
    while len(boxes) < n_boxes:
        cls = rs.choice(len(class_names), p=(0.6, 0.2, 0.2))
        dims = np.asarray(mean_sizes[cls]) * rs.uniform(0.9, 1.1, 3)
        r, th = rs.uniform(5.0, 55.0), rs.uniform(-0.61, 0.61)
        box = np.array([r * np.cos(th), r * np.sin(th), -1.73 + dims[2] / 2, *dims,
                        rs.uniform(-np.pi, np.pi)])
        radius = 0.5 * np.hypot(dims[0], dims[1])
        if all(np.hypot(*(box[:2] - b[:2])) > radius + 0.5 * np.hypot(b[3], b[4]) + 0.3
               for b in boxes):
            boxes.append(box)
            names.append(class_names[cls])
    boxes = np.stack(boxes)
    obj = []
    for b in boxes:
        n = int(np.clip(8000.0 / np.hypot(b[0], b[1]), 40, 600))
        local = (rs.rand(n, 3) - 0.5) * b[3:6] * 0.95
        c, s = np.cos(b[6]), np.sin(b[6])
        obj.append(np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                             local[:, 0] * s + local[:, 1] * c + b[1],
                             local[:, 2] + b[2]], -1))
    obj = np.concatenate(obj)
    n_air = n_points // 10
    n_ground = n_points - len(obj) - n_air
    r = 2.0 + (extent - 2.0) * rs.rand(n_ground) ** 1.6
    th = rs.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th), rs.normal(-1.73, 0.03, n_ground)], -1)
    air = np.stack([rs.uniform(-extent, extent, n_air), rs.uniform(-extent, extent, n_air),
                    rs.uniform(-1.5, 2.5, n_air)], -1)
    xyz = np.concatenate([ground, air, obj])
    pts = np.concatenate([xyz, rs.rand(len(xyz), 1)], -1).astype(np.float32)
    return pts[rs.permutation(len(pts))], boxes, np.array(names)


def write_kitti_root(root, class_names, mean_sizes, seed=0, n_points=KITTI_FRAME_POINTS,
                     splits=KITTI_SPLITS):
    """A synthetic KITTI root in the layout of ``tests/kitti_fixture.py``
    (``training/{velodyne,calib,label_2,image_2,planes}``, ``ImageSets``):
    ``kitti_like_frame`` clouds, the fixture's calibration and road plane,
    labels written from the boxes through the camera conversions (the 2-D
    box projected and clipped to the image, which sets the difficulty), a
    DontCare row last, and 1242 x 375 PNGs.  The test split is empty.
    Returns per split (frames, boxes, fewest points of a frame inside the
    camera's field of view)."""
    from pdanet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
    from pdanet_tpu_torch.utils import box_utils, calibration_kitti
    from pdanet_tpu_torch.utils.png import encode_png

    rs = np.random.RandomState(seed)
    training = root / "training"
    for sub in ("velodyne", "calib", "label_2", "image_2", "planes"):
        (training / sub).mkdir(parents=True)
    (root / "ImageSets").mkdir(parents=True)
    (training / "calib" / "tmp.txt").write_text(KITTI_CALIB)
    calib = calibration_kitti.Calibration(str(training / "calib" / "tmp.txt"))
    (training / "calib" / "tmp.txt").unlink()
    shape = np.array([KITTI_IMAGE[1], KITTI_IMAGE[0]])
    png = encode_png(np.zeros((KITTI_IMAGE[1], KITTI_IMAGE[0], 3), np.uint8))  # black
    counts, frame = {}, 0
    for split, n_frames in splits:
        ids, n_boxes, fov_min = [], 0, None
        for _ in range(n_frames):
            idx = f"{frame:06d}"
            frame += 1
            pts, boxes, names = kitti_like_frame(rs, class_names, mean_sizes, n_points)
            pts.tofile(training / "velodyne" / f"{idx}.bin")
            cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes.astype(np.float32), calib)
            img = box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib, image_shape=shape)
            alpha = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
            lines = [f"{n} 0.00 0 {a:.2f} {b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
                     f"{c[4]:.2f} {c[5]:.2f} {c[3]:.2f} {c[0]:.2f} {c[1]:.2f} {c[2]:.2f} "
                     f"{c[6]:.2f}" for n, a, b, c in zip(names, alpha, img, cam)]
            (training / "label_2" / f"{idx}.txt").write_text(
                "\n".join(lines + [KITTI_DONTCARE]) + "\n")
            (training / "calib" / f"{idx}.txt").write_text(KITTI_CALIB)
            (training / "planes" / f"{idx}.txt").write_text(KITTI_PLANE)
            (training / "image_2" / f"{idx}.png").write_bytes(png)
            n_fov = int(KittiDataset.get_fov_flag(calib.lidar_to_rect(pts[:, :3]), shape,
                                                  calib).sum())
            fov_min = n_fov if fov_min is None else min(fov_min, n_fov)
            ids.append(idx)
            n_boxes += len(boxes)
        (root / "ImageSets" / f"{split}.txt").write_text("\n".join(ids) + "\n")
        counts[split] = (n_frames, n_boxes, fov_min)
    (root / "ImageSets" / "test.txt").write_text("")
    return counts


def annos_as_pred(anno, class_names):
    """A KITTI prediction anno of one frame as a B = 1 ``pred_*`` dict, for
    ``match_detections``."""
    import torch

    labels = [class_names.index(n) + 1 for n in anno["name"]]
    return {"pred_boxes": torch.as_tensor(anno["boxes_lidar"])[None],
            "pred_scores": torch.as_tensor(anno["score"])[None],
            "pred_labels": torch.as_tensor(labels, dtype=torch.long)[None],
            "pred_counts": torch.tensor([len(labels)])}


def kitti_phase(dev, work_dir):
    """Phase 9: the shipped KITTI yaml at full width through the port's
    train and test CLIs on a synthetic KITTI root.  Returns the kernel
    launches of its main path (the train CLI, with its post-train
    evaluation, and the test CLI, counted from 0), and what phase 11 reads
    of the run: the root, its val frames, the batch size, the number of
    steps and the train CLI's median ms per iteration after the first."""
    import torch

    from pdanet_tpu_torch.config import cfg_from_yaml_file
    from pdanet_tpu_torch.datasets import build_dataloader
    from pdanet_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
    from pdanet_tpu_torch.ops import cuda_lib
    from pdanet_tpu_torch.tools import test as test_cli
    from pdanet_tpu_torch.tools import train as train_cli
    from pdanet_tpu_torch.train import load_checkpoint, select_device_batch

    work = Path(work_dir)
    (work / "cfgs").symlink_to(CFGS, target_is_directory=True)
    cfg = cfg_from_yaml_file(str(work / KITTI_CFG_REL))
    root = work / "kitti"
    names = list(cfg.CLASS_NAMES)
    mean_sizes = cfg.MODEL.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size
    n_sample = cfg.DATA_CONFIG.DATA_PROCESSOR[1].NUM_POINTS
    B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU

    # ---- data: the root, infos and gt database
    t0 = time.perf_counter()
    counts = write_kitti_root(root, names, mean_sizes)
    t1 = time.perf_counter()
    create_kitti_infos(cfg.DATA_CONFIG, names, root, root, workers=4)
    print(f"KITTI data: synthetic root {counts} (frames, boxes, fewest points in the camera's "
          f"field of view) of {KITTI_FRAME_POINTS} points a frame, written in {t1 - t0:.1f} s; "
          f"infos and gt database in {time.perf_counter() - t1:.1f} s")
    require(all(fov > n_sample["train"] for _, _, fov in counts.values()),
            f"a frame holds fewer than {n_sample['train']} points in the field of view")
    # the loader alone over one epoch (4 threads, the yaml's augmentor and processors)
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    np.random.seed(0)
    train_set, train_loader, _ = build_dataloader(cfg.DATA_CONFIG, names, B, workers=4,
                                                  training=True)
    batches, data_ms = [], []
    it = iter(train_loader)
    while True:
        t1 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        data_ms.append((time.perf_counter() - t1) * 1e3)
        batches.append(batch)
    require(len(batches) == KITTI_SPLITS[0][1] // B, f"{len(batches)} train batches")
    for batch in batches:
        require(batch["points"].shape == (B, n_sample["train"], 4), "KITTI train batch points")
        require(batch["gt_boxes"].shape == (B, cfg.DATA_CONFIG.MAX_GT_BOXES, 8),
                "KITTI train batch gt")
    n_gt = [int((b["gt_boxes"][..., 7] > 0).sum()) for b in batches]
    print(f"KITTI loader alone (FOV crop; gt sampling on the road plane, flip, rotation, "
          f"scaling; mask, sample {n_sample['train']}, shuffle, sort): {len(batches)} batches "
          f"of {B}, gt boxes per batch {n_gt}, host ms per batch "
          f"{[round(t, 1) for t in data_ms]} (the first waits for the whole window of 4 "
          f"threads)")

    set_data = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
    with contextlib.chdir(work):
        # ---- the train CLI: one epoch at B = 4, bfloat16 as shipped, then the
        # evaluation of the last checkpoint.  The main path's launches start here.
        cuda_lib.launches.clear()
        t0 = time.perf_counter()
        out = train_cli.main(["--cfg_file", KITTI_CFG_REL, "--epochs", "1", "--batch_size",
                              str(B), "--num_epochs_to_eval", "1", *set_data])
        train_s = time.perf_counter() - t0
        train_counts = dict(cuda_lib.launches)
        ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
        # ---- the test CLI on the checkpoint, one frame a batch, --infer_time
        cuda_lib.launches.clear()
        t0 = time.perf_counter()
        result = test_cli.main(["--cfg_file", KITTI_CFG_REL, "--ckpt", str(ckpt),
                                "--batch_size", "1", "--infer_time", *set_data])
        test_s = time.perf_counter() - t0
        test_counts = dict(cuda_lib.launches)
        launches = {k: train_counts.get(k, 0) + test_counts.get(k, 0)
                    for k in set(train_counts) | set(test_counts)}
        print(f"KITTI train CLI (1 epoch, {len(train_set)} frames at B={B}, then the "
              f"evaluation of the last checkpoint): {train_s:.1f} s; kernel launches "
              f"{train_counts}")
        print(f"KITTI test CLI (--infer_time, B=1): {test_s:.1f} s; kernel launches "
              f"{test_counts}")
        for kname in KITTI_TRAIN_KERNELS:
            require(launches.get(kname, 0) > 0, f"kernel {kname} never launched on the "
                    f"KITTI CLI path")

        # what the CLIs wrote
        metrics = [json.loads(line) for line in
                   (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
        series = {}
        for m in metrics:
            series.setdefault(m["tag"], []).append(m["value"])
        losses, step_ms = series["train/loss"], [1e3 * t for t in series["meta_data/batch_time"]]
        wait_ms = [1e3 * t for t in series["meta_data/data_time"]]
        require(len(losses) == len(batches) and all(np.isfinite(losses)),
                f"KITTI train CLI losses {losses}")
        print(f"KITTI train CLI bf16 B={B}: losses {[round(x, 4) for x in losses]}; ms per "
              f"iteration (the step beside the loader's threads, and the wait for the "
              f"loader) {[round(t, 2) for t in step_ms]}, median after the first "
              f"{statistics.median(step_ms[1:]):.2f} ms, of which waiting for the loader "
              f"{[round(t, 2) for t in wait_ms]} ms")
        ck = load_checkpoint(ckpt)
        require(ck["epoch"] == 1 and ck["it"] == len(batches), "KITTI checkpoint epoch / it")
        val_ids = (root / "ImageSets" / "val.txt").read_text().split()
        for res_dir in (out / "eval" / "eval_with_train" / "epoch_1" / "val",
                        out / "eval" / "epoch_1" / "val" / "default"):
            with open(res_dir / "result.pkl", "rb") as f:
                annos = pickle.load(f)
            require([a["frame_id"] for a in annos] == val_ids, f"{res_dir}: frames")
            for a in annos:
                require({"name", "score", "boxes_lidar", "bbox", "location", "frame_id"}
                        <= set(a), f"{res_dir}: KITTI keys {sorted(a)}")
                require(np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all(),
                        f"{res_dir}: detections not finite")
        print(f"KITTI detections per val frame (test CLI): {[len(a['score']) for a in annos]}")
        require("Car_3d/moderate_R40" in result and "recall/rcnn_0.7" in result,
                f"the official KITTI evaluation's result dict: {sorted(result)[:6]}")
        require(all(np.isfinite(float(v)) for v in result.values()), "KITTI result not finite")
        print(f"KITTI official evaluation (random weights after {len(batches)} steps): "
              + json.dumps({k: round(float(v), 4) for k, v in result.items()
                            if k.startswith(("recall/", "Car_3d", "Pedestrian_3d",
                                             "Cyclist_3d"))}))
        log = "".join(p.read_text() for p in (out / "eval" / "epoch_1" / "val" / "default")
                      .glob("log_eval_*.txt"))
        infer = re.findall(r"Average infer time: ([0-9.]+) ms", log)
        require(len(infer) == 1, "the test CLI's --infer_time meter")
        val_set = build_dataloader(cfg.DATA_CONFIG, names, 1, workers=0, training=False)[0]
        t0 = time.perf_counter()
        with recorded_rotate_iou() as eval_iou_calls:  # phase 23 replays them
            val_set.evaluation(annos, names)
        eval_s = time.perf_counter() - t0
        print(f"KITTI eval per frame (test CLI --infer_time: forward, recall, read-back): "
              f"{infer[0]} ms; the official evaluation of {len(annos)} frames "
              f"({sum(len(a['score']) for a in annos)} detections): {eval_s:.2f} s")

        # the same steps with the loader idle: the loader's batches on the card,
        # one step each from the checkpoint; then the device split of one
        model, train_step = _train_model(cfg, cfg.MODEL, ck["model_state"], dev, len(train_set))
        dev_batches = [select_device_batch(b, dev) for b in batches]
        torch.cuda.synchronize()
        idle_ms = []
        for dev_batch in dev_batches:
            t1 = time.perf_counter()
            loss, _ = train_step(dev_batch)
            require(np.isfinite(loss.item()), "KITTI step with the loader idle: loss")
            idle_ms.append((time.perf_counter() - t1) * 1e3)
        print(f"KITTI bf16 B={B} steps on the same batches with the loader idle: ms "
              f"{[round(t, 2) for t in idle_ms]}, median {statistics.median(idle_ms):.2f} ms")
        print_split(f"a KITTI bf16 train step B={B} on a loader batch under torch.profiler",
                    device_split(lambda: train_step(dev_batches[0])))
        del model, train_step, dev_batches

        # ---- one val frame in float32, the checkpoint through the test CLI on the
        # card and on the CPU
        with open(root / "kitti_infos_val.pkl", "rb") as f:
            first = pickle.load(f)[:1]
        with open(root / "kitti_infos_val1.pkl", "wb") as f:
            pickle.dump(first, f)
        f32 = set_data + ["DATA_CONFIG.INFO_PATH.test", "['kitti_infos_val1.pkl']",
                          "MODEL.BACKBONE_3D.COMPUTE_DTYPE", "None",
                          "MODEL.BACKBONE_3D.TRAIN_COMPUTE_DTYPE", "None"]

        def f32_frame(device, thresh):
            tag = f"f32_{'card' if device == 'cuda' else 'cpu'}_{thresh:g}"
            t0 = time.perf_counter()
            test_cli.main(["--cfg_file", KITTI_CFG_REL, "--ckpt", str(ckpt), "--batch_size",
                           "1", "--workers", "0", "--device", device, "--eval_tag", tag,
                           *f32, "MODEL.POST_PROCESSING.SCORE_THRESH", repr(thresh)])
            with open(out / "eval" / "epoch_1" / "val" / tag / "result.pkl", "rb") as f:
                (res,) = pickle.load(f)
            print(f"KITTI float32 frame through the test CLI on {device} at SCORE_THRESH "
                  f"{thresh:g}: {len(res['score'])} detections, "
                  f"{time.perf_counter() - t0:.1f} s")
            return res

        # Eight steps from random weights may leave the frame no box above the
        # yaml's SCORE_THRESH (the loader's draws are reproducible, the card's
        # atomic sums in the backward are not, so the checkpoint differs run to
        # run).  The threshold is then cut tenfold, on the card, until the frame
        # has a detection, and the CPU runs at the threshold the card's
        # comparison run used.
        thresh = float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH)
        g = f32_frame("cuda", thresh)
        while not len(g["score"]) and thresh > 1e-6:
            thresh /= 10
            g = f32_frame("cuda", thresh)
        c = f32_frame("cpu", thresh)
        pairs, n_g, n_c, gap_c, gap_s = match_detections(annos_as_pred(g, names),
                                                         annos_as_pred(c, names))
        print(f"KITTI float32 frame {g['frame_id']} at SCORE_THRESH {thresh:g}, card vs CPU "
              f"through the test CLI: detections {n_g} vs {n_c}, {pairs} paired by mutual "
              f"nearest centre (largest centre distance {gap_c:.3g} m, score {gap_s:.3g})")
        require(n_g > 0, "no KITTI float32 detection to compare")
        require(n_g == n_c == pairs, "KITTI float32 detections differ card vs CPU")
        require(gap_c <= 1e-3, f"KITTI float32 boxes card vs CPU {gap_c} m apart > 1e-3")
    return launches, dict(root=root, val_ids=val_ids, B=B, steps=len(batches),
                          step_ms=statistics.median(step_ms[1:]), eval_iou_calls=eval_iou_calls)


EXPORTS = ((YAML, (1, 2)), (ONCE_YAML, (1,)))  # the yamls exported, and their batch sizes
EXPORT_FRAMES = 3  # LiDAR-like requests each program answers in the fresh process
SERVE_POINTS = (KITTI_FRAME_POINTS,) * 4 + (9000,)  # velodyne files the serve CLI reads
# the fresh process that reloads each saved program: it imports torch and the
# port's ops and serving modules only; argv[1] is a JSON list of (program,
# frame files, output file)
RELOAD = """
import json, sys
import torch
from pdanet_tpu_torch.ops import cuda_lib
from pdanet_tpu_torch.serving import load_serving
report = {}
for program, frames, out in json.loads(sys.argv[1]):
    predict, _ = load_serving(program)
    device = json.load(open(program + ".json"))["device"]
    cuda_lib.launches.clear()
    res = [{k: v.cpu() for k, v in predict({"points": torch.load(f).to(device)}).items()}
           for f in frames]
    report[program] = dict(cuda_lib.launches)
    torch.save(res, out)
report["modules"] = sorted(m for m in sys.modules if m.startswith("pdanet_tpu_torch"))
print(json.dumps(report))
"""


def request_ms(fn, batch, reps=20, warmup=3):
    """Medians of ``fn(batch)`` over ``reps`` requests after ``warmup``, in
    milliseconds: the latency (host clock ending in
    ``torch.cuda.synchronize()``) and the host's enqueue time (until ``fn``
    returns, the device still running)."""
    import torch

    for _ in range(warmup):
        fn(batch)
    torch.cuda.synchronize()
    latency, enqueue = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(batch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        latency.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    return statistics.median(latency), statistics.median(enqueue)


def dispatched_ops(fn, batch):
    """The operators one call ``fn(batch)`` dispatches (aten and the
    port's ops): host work a request pays whatever the device does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn(batch)
    return count.n


def export_phase(dev, work_dir):
    """Phase 10: the shipped KITTI yaml at b1 and b2 and the ONCE yaml at b1
    (full width, bfloat16 as shipped, seeded weights) exported by
    ``serving.export_serving`` and saved; the eager closure's outputs on 3
    LiDAR-like requests a program and on the serve CLI's 5 velodyne files
    (preprocessed as the CLI does); the KITTI b1 program's request latency
    beside the eager closure's with their device busy time (a report).
    Returns no launches of its own and its chain for the tail
    (``export_check``): each program reloaded in a fresh process that
    imports torch and the port's ops and serving modules only, answering
    the 3 requests there (equal detection counts and labels, boxes and
    scores within 1e-5 of the eager closure's, every serving kernel
    launched inside the program), and beside it ``python -m
    pdanet_tpu_torch.tools.serve`` over the velodyne files on the KITTI b1
    program (one JSON line each, equal to the closure's)."""
    import torch

    from pdanet_tpu_torch import serving
    from pdanet_tpu_torch.config import cfg_from_yaml_file
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.tools.serve import frame_detections, load_cloud

    work = Path(work_dir)
    runs = []
    for yaml_path, sizes in EXPORTS:
        cfg = cfg_from_yaml_file(str(yaml_path))
        model = init_random_weights(
            build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev), seed=0)
        closure = serving.make_predict_fn(model, cfg.MODEL)
        pc = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
        for B in sizes:
            label = f"{yaml_path.parent.name.split('_')[0].upper()} b{B}"
            batch = serving.example_device_batch(cfg, serving.serving_input_spec(cfg, B, model),
                                                 dev)
            t0 = time.perf_counter()
            exported = serving.export_serving(model, cfg.MODEL, batch)
            path = work / f"{yaml_path.parent.name}_b{B}.pt2"
            nbytes = serving.save_serving(exported, path, serving.serving_meta(
                cfg, yaml_path.relative_to(ROOT), batch, exported))
            export_s = time.perf_counter() - t0
            frames = []
            for i in range(EXPORT_FRAMES):
                frames.append(work / f"{path.stem}_request{i}.pt")
                torch.save(torch.from_numpy(lidar_like_cloud(
                    1000 + i, B, batch["points"].shape[1], (pc[0], pc[3]), (pc[1], pc[4]))),
                    frames[-1])
            runs.append(dict(label=label, cfg=cfg, closure=closure, path=path,
                             frames=frames, out=work / f"{path.stem}_out.pt",
                             exported=exported))
            print(f"export {label} ({yaml_path.relative_to(ROOT)}, "
                  f"{tuple(batch['points'].shape)}): {export_s:.1f} s, program "
                  f"{nbytes / 1e6:.2f} MB, {len(exported.graph.nodes)} graph nodes")

    # the velodyne files of the serve CLI
    k1 = runs[0]
    cfg = k1["cfg"]
    bins = work / "velodyne"
    bins.mkdir()
    rs = np.random.RandomState(7)
    mean_sizes = cfg.MODEL.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size
    for i, n in enumerate(SERVE_POINTS):
        pts, _, _ = kitti_like_frame(rs, list(cfg.CLASS_NAMES), mean_sizes)
        pts[:n].tofile(bins / f"{i:06d}.bin")  # the frame is shuffled: a random subset
    detections = work / "detections.jsonl"
    thresh = cfg.MODEL.POST_PROCESSING.SCORE_THRESH

    # what the fresh process and the serve CLI must give: the eager
    # closure's outputs on the same frames and preprocessed clouds
    for r in runs:
        r["want"] = [{k: v.cpu() for k, v in r["closure"](
            {"points": torch.load(f).to(dev)}).items()} for f in r["frames"]]
    files = sorted(bins.glob("*.bin"))
    meta = json.loads(Path(f"{k1['path']}.json").read_text())
    _, n_points, num_feats = meta["inputs"]["points"]["shape"]
    serve_want = []
    for f in files:
        pts = load_cloud(str(f), n_points, num_feats, meta["preprocess"]["sort_points"])
        serve_want += frame_detections(
            k1["closure"]({"points": torch.from_numpy(pts[None]).to(dev)}), thresh)

    # latency: the KITTI b1 program (the graph that was saved, run as
    # load_serving runs it) and the eager closure, in turns, in this process
    r = runs[0]
    batch = {"points": torch.load(r["frames"][0]).to(dev)}
    module = r["exported"].module()

    def program(batch):
        with torch.inference_mode():
            return module(batch)

    fns = {"exported": program, "eager": r["closure"]}
    ms = {}
    for name in [*fns, *reversed(fns)]:  # turns: a, b, b, a
        ms.setdefault(name, []).append(request_ms(fns[name], batch))
    for name, fn in fns.items():
        split = device_split(lambda: fn(batch))
        busy = f"{split[1]:.3f} ms in {split[0]} kernels" if split else "not traced"
        (l1, e1), (l2, e2) = ms[name]
        print(f"{r['label']} request, {name}: median latency {l1:.2f} / {l2:.2f} ms, host "
              f"enqueue {e1:.2f} / {e2:.2f} ms over 20 after warm-up (two turns), device "
              f"busy {busy}, {dispatched_ops(fn, batch)} operators dispatched")
    for r in runs:
        del r["closure"], r["exported"]
    return {}, ("exported", lambda: export_check(work, runs, bins, files, serve_want,
                                                 detections, thresh))


def export_check(work, runs, bins, files, serve_want, detections, thresh):
    """Phase 10's chain of the tail (``run_tail``): the fresh process that
    reloads the saved programs (``RELOAD``) and the serve CLI on the KITTI
    b1 program, side by side; each program's requests against the eager
    closure's outputs (``want``, computed in the phase), the serve CLI's
    lines against the closure's on the same preprocessed clouds.  Returns
    the launches of the programs' runs in the fresh process."""
    import collections

    import torch

    t0 = time.perf_counter()
    spec = [(str(r["path"]), [str(f) for f in r["frames"]], str(r["out"])) for r in runs]
    commands = {"reload": [sys.executable, "-c", RELOAD, json.dumps(spec)],
                "serve": [sys.executable, "-m", "pdanet_tpu_torch.tools.serve", "--artifact",
                          str(runs[0]["path"]), "--inputs", f"{bins}/*.bin", "--out",
                          str(detections), "--score_thresh", str(thresh)]}
    procs = {}
    for name, cmd in commands.items():
        with open(work / f"{name}.out", "w") as out, open(work / f"{name}.err", "w") as err:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err,
                                           env=tail_env())
    for name, proc in procs.items():
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        require(proc.returncode == 0, f"{name} process failed:\n"
                f"{(work / f'{name}.err').read_text()[-6000:]}")
    print(f"phase 10's fresh process and serve CLI (in the tail): "
          f"{time.perf_counter() - t0:.1f} s")

    report = json.loads((work / "reload.out").read_text().splitlines()[-1])
    modules = report.pop("modules")
    require(not any(m.split(".")[1] in ("models", "datasets", "train", "eval", "tools")
                    for m in modules if "." in m),
            f"the fresh process imported model code: {modules}")
    print(f"the fresh process imported only {modules}")
    launches = collections.Counter()
    for r in runs:
        got = torch.load(r["out"])
        gap_b = gap_s = 0.0
        counts = []
        for g, want in zip(got, r["want"]):
            require(torch.equal(g["pred_counts"], want["pred_counts"])
                    and torch.equal(g["pred_labels"], want["pred_labels"]),
                    f"{r['label']}: the program's counts or labels differ from the closure's")
            gap_b = max(gap_b, (g["pred_boxes"] - want["pred_boxes"]).abs().max().item())
            gap_s = max(gap_s, (g["pred_scores"] - want["pred_scores"]).abs().max().item())
            counts += want["pred_counts"].tolist()
        require(gap_b <= 1e-5 and gap_s <= 1e-5,
                f"{r['label']}: the program's boxes / scores {gap_b} / {gap_s} from the "
                f"closure's > 1e-5")
        ran = report[str(r["path"])]
        for name in SERVE_KERNELS:
            require(ran.get(name, 0) > 0, f"{r['label']}: kernel {name} never launched inside "
                    f"the exported program")
        launches.update(ran)
        print(f"{r['label']} program in the fresh process, {EXPORT_FRAMES} requests: "
              f"detections {counts} equal to the closure's, boxes within {gap_b:.3g}, scores "
              f"within {gap_s:.3g}; launches {ran}")

    lines = [json.loads(line) for line in detections.read_text().splitlines()]
    require([d.pop("frame") for d in lines] == [f.name for f in files],
            "the serve CLI wrote another line than one per file")
    for f, line, want in zip(files, lines, serve_want):
        require(line == want, f"the serve CLI's detections of {f.name} differ from the "
                f"closure's")
    print(f"serve CLI over {len(files)} velodyne files ({SERVE_POINTS} points; the last "
          f"wrapped to the program's budget): {sum(len(w['scores']) for w in serve_want)} "
          f"detections equal to the closure's; "
          f"{(work / 'serve.err').read_text().strip().splitlines()[-1]}")
    return dict(launches)


# ---------------------------------------------------------------------------
# phase 11: data parallel


DIST_SCRIPTS = ROOT / "pdanet_tpu_torch" / "tools" / "scripts"
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
DP_RANK = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.dp_rank({spec!r}, {rank}, {world}, {port})
"""
DP_STEP = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.dp_step_cost({reps}, {turns!r})
"""
DP_STEP_TURNS = ("none", "identity", "nccl")
DP_STEP_REPS = 3  # B = 4 steps a turn
# the six kernel ops, and the kernels that run each
DP_OPS = {"fps": ("fps",), "ball_query": ("ball_query",),
          "neighbor_attention": ("neighbor_attention", "neighbor_attention_bf16"),
          "neighbor_attention_bwd": ("neighbor_attention_bwd", "neighbor_attention_bwd_bf16"),
          "rotated_iou": ("rotated_iou",), "nms": ("nms",)}
DP_RTOL = 1e-9  # two ranks against one process, float64
# A gradient leaf may also differ by this many times the one process's own
# difference with its frames in reverse order: the DensityNet's first Dense
# feeds a BatchNorm over one input channel, which cancels its scale, so its
# gradient is the eps term's residue of large sums, and any other order of
# summation moves it by ~1e-7 of its scale in float64
DP_ORDER_MARGIN = 10.0
ADAM_EPS = 1e-8  # the yaml's adam_onecycle (optax's default)


class DistScript:
    """``pdanet_tpu_torch/tools/scripts/<script> nproc args`` from ``cwd``
    (torchrun, ``--launcher pytorch``), started in the background, its
    output in files under ``cwd``; ``wait`` checks its exit and returns its
    seconds.  Leaving the ``with`` block kills it if it still runs."""

    def __init__(self, script, nproc, args, cwd, timeout=900):
        env = tail_env({k: v for k, v in os.environ.items() if k not in LAUNCH_ENV})
        self.script, self.timeout, self.t0 = script, timeout, time.perf_counter()
        stem = Path(cwd) / f"{script}.{os.getpid()}.{id(self)}"
        self.out, self.err = open(f"{stem}.out", "w+"), open(f"{stem}.err", "w+")
        self.proc = subprocess.Popen(["bash", str(DIST_SCRIPTS / script), str(nproc), *args],
                                     cwd=cwd, env=env, stdout=self.out, stderr=self.err,
                                     text=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        self.err.close()

    def wait(self):
        try:
            code = self.proc.wait(timeout=max(1.0, self.timeout
                                              - (time.perf_counter() - self.t0)))
        except subprocess.TimeoutExpired:
            code = "timed out"
        seconds = time.perf_counter() - self.t0
        tails = []
        for f, n in ((self.out, 2000), (self.err, 6000)):
            f.seek(0)
            tails.append(f.read()[-n:])
        require(code == 0, f"{self.script} failed (exit {code}):\n{tails[0]}\n{tails[1]}")
        return seconds


def run_dist_script(script, nproc, args, cwd, timeout=900):
    """``DistScript`` in the foreground: returns its seconds."""
    with DistScript(script, nproc, args, cwd, timeout) as run:
        return run.wait()


def cli_log(out_dir, kind):
    """The one log of a CLI run (rank 0's) and the kernel launches it
    reports for its process."""
    logs = list(Path(out_dir).glob(f"log_{kind}_*.txt"))
    require(len(logs) == 1, f"{out_dir}: {len(logs)} {kind} logs")
    log = logs[0].read_text()
    found = re.findall(r"kernel launches of this process: (\{.*\})", log)
    require(len(found) == 1, f"{logs[0]}: no kernel launch line")
    return log, json.loads(found[0])


def dp_cli(work, kitti_run, world=1):
    """Phase 11 (a): the KITTI yaml through ``dist_train.sh`` and
    ``dist_test.sh`` on ``world`` GPUs (one process each, NCCL) on phase
    9's root (at world 1 in the tail, ``run_tail``).  Returns the kernel
    launches of rank 0's CLI processes."""
    import torch

    root, B, val_ids = kitti_run["root"], kitti_run["B"], kitti_run["val_ids"]
    set_data = ["--set", "DATA_CONFIG.DATA_PATH", str(root)]
    group = f"process group: backend nccl, world {world}"
    train_s = run_dist_script("dist_train.sh", world, [
        "--cfg_file", KITTI_CFG_REL, "--epochs", "1", "--batch_size", str(B),
        "--num_epochs_to_eval", "1", "--extra_tag", f"dp{world}", *set_data], work)
    out = Path(work) / "output" / "kitti_models" / "PDA-SSD" / f"dp{world}"
    log, train_counts = cli_log(out, "train")
    require(group in log, f"dist_train.sh: not NCCL at world {world}")
    series = {}
    for line in (out / "tensorboard" / "metrics.jsonl").read_text().splitlines():
        m = json.loads(line)
        series.setdefault(m["tag"], []).append(m["value"])
    losses, step_ms = series["train/loss"], [1e3 * t for t in series["meta_data/batch_time"]]
    require(len(losses) == kitti_run["steps"] // world and all(np.isfinite(losses)),
            f"dist_train.sh losses {losses}")
    ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
    require(sorted(p.name for p in ckpt.parent.iterdir()) == [ckpt.name],
            "dist_train.sh: one checkpoint")
    test_s = run_dist_script("dist_test.sh", world, [
        "--cfg_file", KITTI_CFG_REL, "--ckpt", str(ckpt), "--batch_size", "1",
        "--extra_tag", f"dp{world}", *set_data], work)
    res_dir = out / "eval" / "epoch_1" / "val" / "default"
    tlog, test_counts = cli_log(res_dir, "eval")
    require(group in tlog, f"dist_test.sh: not NCCL at world {world}")
    for res in (out / "eval" / "eval_with_train" / "epoch_1" / "val", res_dir):
        with open(res / "result.pkl", "rb") as f:
            annos = pickle.load(f)
        require([a["frame_id"] for a in annos] == val_ids, f"{res}: merged frames")
        for a in annos:
            require(np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all(),
                    f"{res}: detections not finite")
    print(f"NCCL {'.'.join(str(v) for v in torch.cuda.nccl.version())}")
    print(f"KITTI train CLI through dist_train.sh (torchrun, world {world}, NCCL; 1 epoch at "
          f"B={B} a GPU and the evaluation): {train_s:.1f} s; losses "
          f"{[round(x, 4) for x in losses]}; ms per iteration {[round(t, 2) for t in step_ms]}, "
          f"median after the first {statistics.median(step_ms[1:] or step_ms):.2f} ms against "
          f"{kitti_run['step_ms']:.2f} ms with --launcher none (phase 9, same root; at world 1 "
          f"in the tail, beside other processes); rank 0's kernel launches {train_counts}")
    print(f"KITTI test CLI through dist_test.sh (world {world}, NCCL, B=1 a GPU): {test_s:.1f} "
          f"s, the merged eval covers {len(val_ids)} val frames; rank 0's kernel launches "
          f"{test_counts}")
    return add_launches(train_counts, test_counts)


def dp_step_report(B):
    """Phase 11 (a) at world 1: the collectives' cost a KITTI step at B, the
    same step with and without the group (``DP_STEP``, a fresh process)."""
    res = subprocess.run([sys.executable, "-c", DP_STEP.format(
        root=str(ROOT), reps=DP_STEP_REPS, turns=DP_STEP_TURNS)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(res.returncode == 0, f"the step-cost process failed (exit {res.returncode}):\n"
            f"{res.stdout[-2000:]}\n{res.stderr[-6000:]}")
    lines = res.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    turns = json.loads(lines[-1])
    print(f"KITTI B={B} bf16 step, loader idle, in one process (ms, turns of "
          f"{DP_STEP_REPS}): " + "; ".join(
              f"{kind} {[round(t, 2) for t in times]} (median {statistics.median(times):.2f})"
              for kind, times in turns))


def host_ops(fn, top=8):
    """The host operators of one run of ``fn`` (after a warm-up) under
    torch.profiler: (their number, the ``top`` by self CPU milliseconds
    with their calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return (sum(e.count for e in rows),
            [(e.key, round(e.self_cpu_time_total / 1e3, 3), e.count) for e in rows[:top]])


def dp_step_cost(reps, turns=("none", "nccl", "none")):
    """Phase 11 (a), the collectives' cost, in a fresh process: the yaml's
    B = 4 bfloat16 step on one LiDAR-like batch, the loader idle, in
    ``turns`` of ``reps`` steps each: ``none`` without a process group,
    ``nccl`` in the group of torchrun's world 1 over NCCL (``init_dist``,
    destroyed after the turn), ``identity`` on the data-parallel code path
    with every collective a no-op (no group).  The first turn of each
    kind also prints the device split and the host operators of one step;
    the first ``nccl`` turn the host time of one all-reduce call.  Prints
    one JSON line: [kind, step times] a turn."""
    import torch
    import torch.distributed as dist

    from pdanet_tpu_torch import parallel
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.utils import common_utils

    dev = torch.device("cuda", 0)
    cfg = load_config()
    weights = init_random_weights(build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev),
                                  seed=0).state_dict()
    model, train_step = _train_model(cfg, cfg.MODEL, weights, dev)
    mean_size = np.asarray(cfg.MODEL.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size,
                           np.float32)
    pts, gt = lidar_like_batch(400, cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU, N_POINTS, mean_size)
    batch = {"points": torch.from_numpy(pts).to(dev), "gt_boxes": torch.from_numpy(gt).to(dev)}
    small = torch.ones(65, device=dev, requires_grad=True)

    class Clone(torch.autograd.Function):  # parallel's Function without the collective
        @staticmethod
        def forward(ctx, t):
            return t.clone()

        @staticmethod
        def backward(ctx, grad):
            return grad.clone()

    def step_times():
        train_step(batch)  # warm-up
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    res, seen = [], set()
    for kind in turns:
        if kind == "nccl":
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                              MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
            common_utils.init_dist("pytorch")
            require(dist.get_backend() == "nccl", f"init_dist took {dist.get_backend()}")
        own = parallel.is_dist, dist.all_reduce
        if kind == "identity":
            parallel.is_dist, dist.all_reduce = (lambda: True), (lambda t, *a, **k: None)
        try:
            res.append((kind, step_times()))
            if kind not in seen:
                what = {"none": "no process group", "nccl": "NCCL at world 1",
                        "identity": "the data-parallel path, collectives no-ops"}[kind]
                print_split(f"a B=4 bf16 step, {what}", device_split(lambda: train_step(batch)))
                print(f"host operators of a B=4 bf16 step, {what}: "
                      f"{host_ops(lambda: train_step(batch))}")
            if kind == "nccl" and kind not in seen:
                print(f"host time of one call at world 1 (µs, median of 200): dist.all_reduce "
                      f"of 65 float32 {host_us(lambda: dist.all_reduce(small.detach())):.1f}; "
                      f"parallel.all_reduce_sum "
                      f"{host_us(lambda: parallel.all_reduce_sum(small)):.1f}; the same "
                      f"forward and backward "
                      f"{host_us(lambda: parallel.all_reduce_sum(small).sum().backward()):.1f}; "
                      f"a Python autograd Function's clone, forward and backward "
                      f"{host_us(lambda: Clone.apply(small).sum().backward()):.1f}; "
                      f"small.sum() {host_us(lambda: small.sum()):.1f}")
        finally:
            parallel.is_dist, dist.all_reduce = own
            if kind == "nccl":
                dist.destroy_process_group()
        seen.add(kind)
    print(json.dumps(res))


def _f32_model_cfg(cfg):
    mcfg = copy.deepcopy(cfg.MODEL)
    mcfg.BACKBONE_3D.pop("COMPUTE_DTYPE", None)
    mcfg.BACKBONE_3D.pop("TRAIN_COMPUTE_DTYPE", None)
    return mcfg


def _predict_frames(cfg, weights, dev, pts):
    """The frames ``pts`` through the serving closure (bfloat16 as shipped):
    the detections per frame."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.serving import make_predict_fn

    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev)
    model.load_state_dict(weights)
    res = make_predict_fn(model, cfg.MODEL)({"points": torch.as_tensor(pts).to(dev)})
    require(all(bool(torch.isfinite(v.float()).all()) for v in res.values()),
            "data-parallel frames: detections not finite")
    return res["pred_counts"].tolist()


def _ops_run(counts):
    return [op for op, kernels in DP_OPS.items() if any(counts.get(k, 0) for k in kernels)]


def dp_rank(spec_path, rank, world, port):
    """One rank of phase 11 (b), in its own process, in a group of
    ``world`` at ``tcp://127.0.0.1:port``: under Gloo on the one process's
    device, under NCCL on ``cuda:<rank>``.  The float32 train step of its
    frame (the data-parallel path through every train kernel), the float64
    step with the one process's indices of its frame fed, and its frame
    through the serving closure.  Writes the results to
    ``<spec>.rank<rank>`` and prints its kernel launches."""
    import torch
    import torch.distributed as dist

    from pdanet_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    nccl = spec["backend"] == "nccl"
    dev = torch.device("cuda", rank) if nccl else torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = spec["cfg"]
    mcfg = _f32_model_cfg(cfg)
    mine = slice(rank, rank + 1)
    pts, gt = spec["points"][mine], spec["gt_boxes"][mine]
    dist.init_process_group(spec["backend"], init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, **({"device_id": dev} if nccl else {}))
    try:
        cuda_lib.launches.clear()
        model, train_step = _train_model(cfg, mcfg, spec["weights"], dev)
        loss32, _ = train_step({"points": torch.as_tensor(pts).to(dev),
                                "gt_boxes": torch.as_tensor(gt).to(dev)})
        state32 = {n: t.detach().cpu() for n, t in model.state_dict().items()}
        del model, train_step
        samp = [p[mine] for p in spec["picks"]]
        ball = [tuple(t[mine] for t in b) for b in spec["ball"]]
        with fed(sampling=lambda *a: samp.pop(0).to(a[3].device),
                 ball_query=lambda r, n, xyz, c: tuple(t.to(xyz.device) for t in ball.pop(0))):
            rec64 = _recorded_step(cfg, mcfg, spec["weights"], dev, torch.float64, pts, gt)
        require(not samp and not ball, f"rank {rank}: fed indices left over")
        rec64.pop("out")
        detections = _predict_frames(cfg, spec["weights"], dev, pts)
        launches = dict(cuda_lib.launches)
    finally:
        dist.destroy_process_group()
    torch.save(dict(loss32=loss32.item(), state32=state32, rec64=rec64,
                    detections=detections), f"{spec_path}.rank{rank}")
    print(json.dumps({"rank": rank, "launches": launches}))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_ranks(dev, cfg, weights, work, world=1):
    """Phase 11 (b): ranks of one frame each against one process on the
    same frames -- on one card (``world`` 1) two ranks sharing it through
    Gloo, on ``world`` cards one rank a card over NCCL.  Runs the one
    process; returns its kernel launches and ``ranks()``, which starts the
    ranks, checks them against the one process and returns the ranks'
    launches (phase 11 at world 1 leaves it to the tail)."""
    import torch

    from pdanet_tpu_torch.ops import cuda_lib

    n_ranks = 2 if world == 1 else world
    backend = "nccl" if world > 1 and dev.type == "cuda" else "gloo"
    mcfg = _f32_model_cfg(cfg)
    mean_size = np.asarray(mcfg.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size,
                           np.float32)
    pts, gt = lidar_like_batch(600, n_ranks, N_POINTS, mean_size)

    # one process, B = n_ranks: a float32 step (its picks are fed to every
    # float64 step), the float64 step, and the frames through the serving
    # closure
    cuda_lib.launches.clear()
    one32 = _recorded_step(cfg, mcfg, weights, dev, torch.float32, pts, gt)
    picks = [i.cpu() for k, i in enumerate(one32["out"]["sampled_idx"])
             if i is not None and not one32["fps_identity"][k]]
    ball = [tuple(t.cpu() for t in b) for b in one32["out"]["ball_query_idx"] if b is not None]
    with fed(**feed_all(picks, one32)):
        one64 = _recorded_step(cfg, mcfg, weights, dev, torch.float64, pts, gt)
    # its own rounding: the float64 step with its frames in reverse order
    swap = list(range(n_ranks))[::-1]
    with fed(**feed_all([p[swap] for p in picks],
                        {"out": {"ball_query_idx": [tuple(t[swap] for t in b) for b in ball]}})):
        swapped = _recorded_step(cfg, mcfg, weights, dev, torch.float64, pts[swap], gt[swap])
    one_detections = _predict_frames(cfg, weights, dev, pts)
    one_launches = dict(cuda_lib.launches)

    spec = Path(work) / "dp_spec.pt"
    torch.save(dict(cfg=cfg, device=str(dev), backend=backend,
                    weights={k: v.cpu() for k, v in weights.items()},
                    points=pts, gt_boxes=gt, picks=picks, ball=ball), spec)
    return one_launches, lambda: dp_ranks_check(cfg, spec, n_ranks, backend, one64, swapped,
                                                one_detections, one_launches)


def dp_ranks_check(cfg, spec, n_ranks, backend, one64, swapped, one_detections, one_launches):
    """Phase 11 (b), the ranks: ``n_ranks`` processes (``dp_rank``) on the
    frames of ``spec``, checked against the one process's float64 step
    (``one64``, ``swapped`` with its frames reversed), detections and
    launches.  Returns the ranks' launches."""
    import torch

    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", DP_RANK.format(
        root=str(ROOT), spec=str(spec), rank=r, world=n_ranks, port=port)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(n_ranks)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    ranks_s = time.perf_counter() - t0
    rank_launches = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"data-parallel rank {r} failed (exit {p.returncode}):\n"
                f"{out[-2000:]}\n{err[-6000:]}")
        line = json.loads(out.strip().splitlines()[-1])
        require(line["rank"] == r, f"rank {r}: {line}")
        rank_launches.append(line["launches"])
    got = [torch.load(f"{spec}.rank{r}", weights_only=False) for r in range(n_ranks)]

    # the ranks hold one state: bit for bit after either step
    for other in got[1:]:
        for key, val in got[0]["state32"].items():
            require(torch.equal(other["state32"][key], val), f"float32 ranks differ at {key}")
        for what in ("params", "stats", "grads"):
            for key, val in got[0]["rec64"][what].items():
                require(torch.equal(other["rec64"][what][key], val),
                        f"float64 ranks' {what} differ at {key}")
        require(got[0]["rec64"]["loss"] == other["rec64"]["loss"],
                "float64 ranks' losses differ")
    require(all(np.isfinite(g["loss32"]) for g in got), "float32 data-parallel loss")

    # against the one process: loss, every gradient leaf (over its scale,
    # floored at 1e-3 of the largest leaf's: below that a float64 gradient
    # is rounding noise; or over DP_ORDER_MARGIN times the leaf's own
    # difference under the swap), BN statistics, and parameters after the
    # update (Adam's first update moves a parameter by lr * g / (|g| + eps),
    # which amplifies a gradient's rounding by up to lr / eps: the bound
    # adds that to DP_RTOL of the leaf's scale)
    rec, want = got[0]["rec64"], one64
    rel = abs(rec["loss"] - want["loss"]) / abs(want["loss"])
    gerrs = _leaf_errors(rec["grads"], want["grads"], 1e-3)
    order = _leaf_errors(swapped["grads"], want["grads"], 1e-3)
    top = 1e-3 * max(w.abs().max().item() for w in want["grads"].values())
    gbound = []
    for n, w in want["grads"].items():
        err = (rec["grads"][n] - w).abs().max().item()
        own = (swapped["grads"][n] - w).abs().max().item()
        gbound.append((err / max(DP_RTOL * max(w.abs().max().item(), top),
                                 DP_ORDER_MARGIN * own), n))
    gbound.sort(reverse=True)
    serr = max((rec["stats"][n] - s).abs().max().item() / max(s.abs().max().item(), 1.0)
               for n, s in want["stats"].items())
    lr = float(cfg.OPTIMIZATION.LR)  # at least the first update's rate
    perrs = []
    for n, w in want["params"].items():
        dg = (rec["grads"][n] - want["grads"][n]).abs().max().item()
        err = (rec["params"][n] - w).abs().max().item()
        perrs.append((err / (DP_RTOL * max(w.abs().max().item(), 1.0) + lr * dg / ADAM_EPS), n))
    perrs.sort(reverse=True)
    print(f"{n_ranks} ranks through {backend} (one frame each) against one process at "
          f"B={n_ranks}, float64, indices fed: loss {rec['loss']!r} vs {want['loss']!r} "
          f"(rel {rel:.3g}); {len(gerrs)} gradient leaves, largest err / scale "
          f"{gerrs[0][0]:.3g} ({gerrs[0][1]}), deciles {_deciles(gerrs)}; the one process "
          f"with its frames reversed, largest {order[0][0]:.3g} ({order[0][1]}), deciles "
          f"{_deciles(order)}; largest err over its bound {gbound[0][0]:.3g} ({gbound[0][1]}); "
          f"BN statistics {serr:.3g}; parameters after the update, largest err over its "
          f"bound {perrs[0][0]:.3g} ({perrs[0][1]}); the ranks' state bit-equal after the "
          f"float32 and float64 steps")
    print(f"float32 data-parallel step (unfed): losses {[g['loss32'] for g in got]}; "
          f"detections a frame: ranks {[g['detections'] for g in got]}, one process "
          f"{one_detections}; the ranks' processes {ranks_s:.1f} s")
    print(f"kernel launches: one process {one_launches}; ranks {rank_launches}")
    require(rel <= DP_RTOL, f"float64 data-parallel loss rel {rel} > {DP_RTOL}")
    require(gbound[0][0] <= 1.0, f"float64 data-parallel gradient {gbound[0][1]}: "
            f"{gbound[0][0]} times its bound")
    require(serr <= DP_RTOL, f"float64 data-parallel BN statistics: {serr} > {DP_RTOL}")
    require(perrs[0][0] <= 1.0, f"float64 data-parallel parameter {perrs[0][1]}: "
            f"{perrs[0][0]} times its bound")
    for who, counts in (("the one process", one_launches),
                        *((f"rank {r}", c) for r, c in enumerate(rank_launches))):
        require(_ops_run(counts) == list(DP_OPS), f"{who} ran the ops {_ops_run(counts)}")
    return add_launches(*rank_launches)


def check_off_device(dev):
    """Each kernel on tensors of ``dev`` while ``cuda:0`` is the current
    device, against its plain version on ``dev``: the wrappers' device
    guard.  Returns the number of kernel launches it saw."""
    import torch

    from pdanet_tpu_torch.ops import attention, ball_query, cuda_lib, nms, rotated_iou, sampling

    torch.cuda.set_device(0)
    cuda_lib.launches.clear()
    xyz = torch.from_numpy(lidar_like_cloud(7, 1, N_POINTS)[..., :3].copy()).to(dev)
    idx = sampling.farthest_point_sample_cuda(xyz, 4096)
    require(torch.equal(idx, sampling.farthest_point_sample_plain(xyz, 4096)),
            f"FPS on {dev} differs from its plain version")
    ctr = xyz[:, idx[0].long()].contiguous()
    for got, want in zip(ball_query.ball_query_multi_cuda((0.2, 0.8), (16, 32), xyz, ctr),
                         ball_query.ball_query_multi_plain((0.2, 0.8), (16, 32), xyz, ctr)):
        require(torch.equal(got, want), f"ball query on {dev} differs from its plain version")
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn(1024 * 32, 4 * 64, device=dev, generator=g) for _ in range(4))
    err = (attention.neighbor_attention_flat_cuda(q, k, v, 32, 4, 64)
           - attention.neighbor_attention_flat_plain(q, k, v, 32, 4, 64)).abs().max().item()
    require(err <= 2e-5, f"attention on {dev}: err {err}")
    for got, want in zip(attention.neighbor_attention_flat_bwd_cuda(q, k, v, do, 32, 4, 64),
                         attention.neighbor_attention_flat_bwd_plain(q, k, v, do, 32, 4, 64)):
        err = (got - want).abs().max().item()
        require(err <= 2e-5, f"attention backward on {dev}: err {err}")
    boxes = torch.from_numpy(random_boxes(5, 1, 256)).to(dev)
    iou = rotated_iou.boxes_iou_bev_batched_self_cuda(boxes)
    require(torch.allclose(iou, rotated_iou.boxes_iou_bev_batched_self_plain(boxes),
                           rtol=2e-4, atol=2e-5), f"IoU on {dev} differs from its plain version")
    valid = torch.ones(1, 256, dtype=torch.bool, device=dev)
    require(torch.equal(nms.greedy_nms_mask_batched_cuda(iou, valid, 0.1),
                        nms.greedy_nms_mask_batched_plain(iou, valid, 0.1)),
            f"NMS on {dev} differs from its plain version")
    require(torch.cuda.current_device() == 0, "a wrapper left its device current")
    return sum(cuda_lib.launches.values())


def dp_phase(dev, work_dir, kitti_run, cfg, weights, world=1):
    """Phase 11: data parallel.  (a) at world 1 the collectives' cost a step
    (the CLIs over NCCL, ``dp_cli``, run in the tail); on ``world`` GPUs
    the CLIs, (b) ranks of one frame each against one process (at world 1
    the ranks' processes run in the tail).  Returns the kernel launches of
    every run, counted from 0, and at world 1 the ranks' chain for the
    tail."""
    if world == 1:
        dp_step_report(kitti_run["B"])
        one, ranks = dp_ranks(dev, cfg, weights, work_dir, world)
        return one, ("dp", ranks)
    one, ranks = dp_ranks(dev, cfg, weights, work_dir, world)
    return add_launches(dp_cli(work_dir, kitti_run, world), one, ranks())


# ---------------------------------------------------------------------------
# phases 12 and 13: the voxel detectors, PointPillar and SECOND


PP_CFG_REL = "cfgs/kitti_models/pointpillar.yaml"  # in phase 9's working directory
SECOND_CFG_REL = "cfgs/kitti_models/second.yaml"
VRCNN_CFG_REL = "cfgs/kitti_models/voxel_rcnn_car.yaml"
SECOND_IOU_CFG_REL = "cfgs/kitti_models/second_iou.yaml"
MULTIHEAD_CFG_REL = "cfgs/kitti_models/second_multihead.yaml"
CENTERPOINT_CFG_REL = "cfgs/kitti_models/centerpoint.yaml"
PV_CFG_REL = "cfgs/kitti_models/pv_rcnn.yaml"
PVPP_CFG_REL = "cfgs/kitti_models/pv_rcnn_plusplus.yaml"
PV_NAMES = ("PVRCNN", "PVRCNNPlusPlus")
PARTA2_CFG_REL = "cfgs/kitti_models/PartA2.yaml"
PARTA2_FREE_CFG_REL = "cfgs/kitti_models/PartA2_free.yaml"
POINTRCNN_CFG_REL = "cfgs/kitti_models/pointrcnn.yaml"
POINTRCNN_IOU_CFG_REL = "cfgs/kitti_models/pointrcnn_iou.yaml"
# phase 18's CLIs and dist_train.sh train on a root of their own: a Part-A2
# step takes ~1 s, phase 9's 8 CLI frames would give 2 steps of B = 4 a run
PARTA2_CLI_SPLITS = (("train", 2), ("val", 2))
PARTA2_CLI_BATCH = 2
AUG_CFG_RELS = ("cfgs/kitti_models/pointpillar_newaugs.yaml",
                "cfgs/kitti_models/pointpillar_pyramid_aug.yaml")
# phase 16's augmentor yamls train on a root of their own: 4 train frames,
# one step at the yaml's B = 4
AUG_CLI_SPLITS = (("train", 4), ("val", 2))
# phase: (yaml, label, seed of the served frames; the train frames' is 100 more)
VOXEL_PHASES = {12: (PP_CFG_REL, "PointPillar", 1200), 13: (SECOND_CFG_REL, "SECOND", 1200),
                14: (VRCNN_CFG_REL, "Voxel-RCNN", 1400),
                "15a": (SECOND_IOU_CFG_REL, "SECOND-IoU", 1500),
                "15b": (MULTIHEAD_CFG_REL, "SECOND-multihead", 1500),
                16: (CENTERPOINT_CFG_REL, "CenterPoint", 1600),
                17: (PV_CFG_REL, "PV-RCNN", 1700), "17b": (PVPP_CFG_REL, "PV-RCNN++", 1700),
                "18a": (PARTA2_CFG_REL, "Part-A2", 1800),
                "18b": (PARTA2_FREE_CFG_REL, "Part-A2-free", 1800),
                "19a": (POINTRCNN_CFG_REL, "PointRCNN", 1900),
                "19b": (POINTRCNN_IOU_CFG_REL, "PointRCNN-IoU", 1900)}
# the suffix of a phase's rows in the kernels line
VOXEL_SUFFIX = {12: "", 13: "_second", 14: "_voxel_rcnn", "15a": "_second_iou",
                "15b": "_multihead", 16: "_centerpoint", 17: "_pv_rcnn", "17b": "_pv_rcnn_pp",
                "18a": "_part_a2", "18b": "_part_a2_free", "19a": "_pointrcnn",
                "19b": "_pointrcnn_iou", 20: "_caddn"}
VOXEL_SERVE_FRAMES = 5  # three b1 requests and one b2
VOXEL_TRAIN_STEPS = 5
VOXEL_LATENCY_REPS = 10
# the card-vs-CPU checks of the dense 3-D backbone run on this crop of
# POINT_CLOUD_RANGE (the voxel size, widths and every other setting the
# yaml's): 256 x 256 x 40 cells, where the full grid's 41 x 1600 x 1408
# would take the host minutes and tens of GB a forward
DENSE_CROP = (0.0, -6.4, -3.0, 12.8, 6.4, 1.0)
# phase 15's CLIs train on a root of their own: a B=1 step of the dense
# ladder takes seconds, an epoch of phase 9's 32 frames minutes
DENSE_CLI_SPLITS = (("train", 1), ("val", 2))
# the train CLIs and dist_train.sh of phases 12-14, 16 and 17 train one
# epoch over the first frames of phase 9's train split (its infos cut to
# these, ``cli_run``), its four val frames to test
CLI_TRAIN_FRAMES = 4
# the depth of phases 12-19, cut to keep the script well inside its limit
# (their widths, every kernel row and every entry point stay; the module
# docstring's "Depth" says what each phase runs).  Keys: latency_reps;
# serve_requests (b1, b2, b1, b1: the first n); train_steps, batch_size;
# train_split (a device split of a step); tf32 / layout (the latency turns
# with TF32 on, in channels-last-3d); crop (the CPU side of the dense
# ladder's checks and the float64 step on DENSE_CROP); float64 (the
# float64 step card vs CPU); compare (the float32 frame card vs CPU); cli,
# cli_root / cli_batch (the CLIs on a root of their own), cli_export,
# dist_train; iou_rows ((e)'s IoU / NMS rows).  The reasons: phase 15
# trains at B=1 (the yaml's 4 would need four times B=1's ~35 GiB); 16 and
# 17 have no TF32 turns (13 times the same BEV convolution with TF32 on);
# 18a and 18b share a root of 2 + 2 frames (a Part-A2 step takes ~1 s);
# 15b, 17b and 18b take no float64 step (their code is 15a's, 17's, and
# 18a's and 19a's), 16's and the dense ladder's run on DENSE_CROP (the
# CPU's float64 step takes 15-27 s a yaml at full width); dist_train.sh
# runs for one model of each family, PointPillar, Voxel-RCNN (the sparse
# backbone and a second stage), PV-RCNN, PointRCNN and CaDDN (phase 20),
# so that the tail's chains run in one wave (with phase 21, 13 chains took
# two waves, 180.2 s on a slow host)
VOXEL_DEPTH = {12: dict(latency_reps=3, serve_requests=2, train_steps=1, tf32=False),
               13: dict(latency_reps=3, serve_requests=2, train_steps=1, train_split=False,
                        dist_train=False),
               14: dict(latency_reps=3, serve_requests=2, train_steps=1, train_split=False,
                        tf32=False),
               "15a": dict(latency_reps=3, serve_requests=2, train_steps=1, batch_size=1,
                           crop=DENSE_CROP, cli_root=DENSE_CLI_SPLITS, cli_export=True,
                           dist_train=False, layout=False, train_split=False),
               "15b": dict(latency_reps=3, train_steps=1, batch_size=1, crop=DENSE_CROP,
                           serve_requests=1, cli=False, layout=False, train_split=False,
                           tf32=False, float64=False),
               16: dict(latency_reps=3, serve_requests=2, train_steps=1, tf32=False,
                        crop=DENSE_CROP, dist_train=False),
               17: dict(latency_reps=3, serve_requests=2, train_steps=1, train_split=False,
                        tf32=False),
               "17b": dict(latency_reps=3, train_steps=1, serve_requests=1, cli=False,
                           tf32=False, train_split=False, iou_rows=False, float64=False),
               "18a": dict(latency_reps=3, serve_requests=2, train_steps=1, train_split=False,
                           tf32=False, crop=DENSE_CROP, cli_root=PARTA2_CLI_SPLITS,
                           cli_batch=PARTA2_CLI_BATCH, dist_train=False),
               "18b": dict(latency_reps=3, serve_requests=2, train_steps=1, train_split=False,
                           tf32=False, float64=False, cli_root=PARTA2_CLI_SPLITS,
                           cli_batch=PARTA2_CLI_BATCH, dist_train=False),
               "19a": dict(latency_reps=3, serve_requests=2, train_steps=2, train_split=False,
                           tf32=False),
               "19b": dict(latency_reps=3, serve_requests=1, train_steps=1, train_split=False,
                           tf32=False, cli_batch=2, compare=False, float64=False,
                           iou_rows=False, dist_train=False)}
VOXEL_KERNELS = ("rotated_iou", "nms")  # the kernels of their path
# PV-RCNN's float32 keypoint features (each source's, fused), point scores
# and RCNN outputs, card against CPU, the CPU run on the card's inputs, of
# max(1, |value|): on an H100 the stages read 2.92e-07 at most (PV-RCNN++
# 1.91e-06, rcnn_reg) with TF32 off; the control, the card's stages with
# TF32 on, 4.68e-05 to 8.47e-04 (PV-RCNN++ 1.11e-05 to 2.47e-03)
PV_STAGE_TOL = 1e-5
# Part-A2's float32 stages, card against CPU, of max(1, |value|): the UNet's
# voxel features and the point head's outputs of each device's own first
# stage, the RoI head's outputs on the card's pooled grids; the control, the
# card's stages with TF32 on, must exceed it
PARTA2_STAGE_TOL = 1e-5
# (RoI, point) memberships of PointRCNN's RoI point pool that may differ
# card against CPU on the card's inputs: a point within a float32 ulp of a
# box's face rounds to either side (the rotation's cos and sin on each
# device); the pooled clouds are held to PV_STAGE_TOL at every RoI that no
# flipped pair touches
POINTRCNN_POOL_FLIPS = 2
# (RoI, voxel) cell assignments of the RoI-aware pool that may differ card
# against CPU on the card's inputs: a voxel centre within a float32 ulp of
# a cell's border or of the box's side rounds to either side; the pooled
# grids are held to PARTA2_STAGE_TOL at every cell that no flipped pair
# leaves or enters
PARTA2_CELL_FLIPS = 2
# a two-stage model's seeded box conv is scaled by this: the seeded weights
# decode boxes millimetres thin and tens of metres from their anchors,
# whose IoU with any box is ~0 (no proposal suppressed, no foreground RoI,
# the grid points of a RoI in one spot); scaled, the boxes stay near their
# anchors
BOX_CONV_SCALE = 0.01
# CenterPoint's seeded head decodes boxes of random size (the exp of its
# dim map) and heading (the atan2 of its rot map), so that no two of the
# 500 candidates overlap by the NMS threshold 0.7 and none is suppressed;
# its dim, centre and heading-sine output convs are scaled by this, the dim
# bias set to the log of the first class's mean size: boxes of that size,
# at heading 0 or pi, at their cells, which neighbouring peaks overlap
CENTER_CONV_SCALE = 0.01
# CenterPoint's float32 head maps, card against CPU, of max(1, |value|):
# three runs on an H100 read 8.05e-07 at most (the centre map) and 5.96e-08
# on the sigmoided heatmap, both TF32 off: the gate is 12 times the larger
CENTER_MAPS_TOL = 1e-5
PLANTED_GT = 2  # gt boxes planted on each training frame's proposals (two-stage)
SPARSE_LEVELS = ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "conv_out")
KITTI_MEAN_SIZES = {"Car": (3.9, 1.6, 1.56), "Pedestrian": (0.8, 0.6, 1.73),
                    "Cyclist": (1.76, 0.6, 1.73)}  # phase 9's frames, all three classes
# the fresh process that reloads the saved voxel programs: it imports torch
# and the port's ops and serving modules only, and computes float32 as this
# process does (TF32 off); stdin: a JSON line (program, batch file, output)
# a program, as each is saved; one JSON line a program (its request's
# launches), then the modules it imported
RELOAD_VOXELS = """
import json, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False  # as phase 1 sets them here
torch.backends.cudnn.allow_tf32 = False
from pdanet_tpu_torch.ops import cuda_lib
from pdanet_tpu_torch.serving import load_serving
for line in sys.stdin:
    program, batch, out = json.loads(line)
    t0 = time.perf_counter()
    predict, _ = load_serving(program)
    batch = torch.load(batch)
    cuda_lib.launches.clear()
    cuda_lib.launches_by_k.clear()
    cuda_lib.launches_by_site.clear()
    torch.save({k: v.cpu() for k, v in predict(batch).items()}, out)
    del predict, batch
    torch.cuda.empty_cache()
    print(json.dumps({"launches": {**cuda_lib.launches, **cuda_lib.launches_by_k,
                                   **cuda_lib.launches_by_site},
                      "seconds": time.perf_counter() - t0}), flush=True)
print(json.dumps({"modules": sorted(m for m in sys.modules
                                    if m.startswith("pdanet_tpu_torch"))}))
"""
# the tail's processes at once (``run_tail``, which prints the card's peak
# memory in use while they run): the programs' fresh process, phase 11's
# dist_train.sh / dist_test.sh, phase 10's fresh process and serve CLI and
# the voxel phases' dist_train.sh runs at B = 1, seven chains at a time (7
# chains, one wave of 77-98 s), beside ``EXPORT_WORKERS`` processes
# exporting the phases' b1 programs (12 programs of 8-39 s: ~100 s in
# three processes, ~150 s in two)
TAIL_WORKERS = 8
EXPORT_WORKERS = 3
# torch's CPU threads in each of the tail's processes (its default, a thread
# a core, gives every one of the ~16 processes at once all 8 cores): the
# processes' work is on the card, their CPU side reads files and enqueues
TAIL_THREADS = 2


def tail_env(env=None):
    """``env`` (this process's environment by default) with the tail's
    processes' CPU threads (``TAIL_THREADS``)."""
    return {**(os.environ if env is None else env), "OMP_NUM_THREADS": str(TAIL_THREADS)}
# a tail export process: argv[1] a JSON list of ``voxel_export``'s jobs;
# each built from its yaml and saved weights, exported at b1 and saved
# with its sidecar, then one JSON line (its stem, seconds, bytes, nodes)
EXPORT_PROGRAMS = """
import json, os, sys, time
import torch
from pdanet_tpu_torch import serving
from pdanet_tpu_torch.config import cfg_from_yaml_file
from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
from pdanet_tpu_torch.models import build_network
dev = torch.device("cuda", 0)
for job in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    cfg = cfg_from_yaml_file(job["cfg_file"])
    template = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                               training=False, root_path=job["root"])
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template, device=dev)
    model.load_state_dict(torch.load(job["stem"] + ".weights.pt"))
    exported = serving.export_serving(model, cfg.MODEL, serving.example_device_batch(
        cfg, serving.serving_input_spec(cfg, 1, model), dev))
    nbytes = serving.save_serving(exported, job["stem"] + ".pt2", serving.serving_meta(
        cfg, job["cfg_rel"], torch.load(job["stem"] + ".batch.pt"), exported))
    print(json.dumps({"stem": job["stem"], "seconds": time.perf_counter() - t0,
                      "bytes": nbytes, "nodes": len(exported.graph.nodes),
                      "worker": os.getpid()}), flush=True)
    del model, exported
    torch.cuda.empty_cache()
"""


def clear_launches():
    from pdanet_tpu_torch.ops import cuda_lib

    cuda_lib.launches.clear()
    cuda_lib.launches_by_k.clear()
    cuda_lib.launches_by_site.clear()


def counted_launches():
    """The launches since :func:`clear_launches`: each kernel's, the IoU's
    and the NMS walk's at each K (``<name>_k<K>``), and the ball query's at
    each named site (``ball_query_<site>``)."""
    from pdanet_tpu_torch.ops import cuda_lib

    return {**cuda_lib.launches, **cuda_lib.launches_by_k, **cuda_lib.launches_by_site}


def add_launches(*runs):
    return {k: sum(r.get(k, 0) for r in runs) for k in set().union(*runs)}


def ball_query_sites(model):
    """The sites of ``model``'s ball queries (``MaskedSAModuleMSG.site``):
    PV-RCNN's feature sources and RoI grid pool that aggregate by the ball
    query, not VectorPool."""
    from pdanet_tpu_torch.models.backbones_3d.pfe.voxel_set_abstraction import (
        MaskedSAModuleMSG)

    return [m.site for m in model.modules() if isinstance(m, MaskedSAModuleMSG)]


def path_kernels(model):
    """The launch counts a voxel model's path must raise: the IoU's and the
    NMS walk's; PV-RCNN's VSA adds FPS's and, with the ball query's, its
    count at each of ``ball_query_sites`` (``ball_query_<site>``);
    PointRCNN's path adds FPS's (and its count on the RoIs' clouds,
    ``fps_n<K>``) and the ball query's (and its count in the RoI head)."""
    if is_pointrcnn_model(model):
        from pdanet_tpu_torch.models.roi_heads.pointrcnn_head import BALL_QUERY_SITE

        return VOXEL_KERNELS + ("fps", f"fps_n{model.roi_head.num_sampled}", "ball_query",
                                f"ball_query_{BALL_QUERY_SITE}")
    if not hasattr(model, "pfe"):
        return VOXEL_KERNELS
    sites = ball_query_sites(model)
    return (VOXEL_KERNELS + ("fps",) + (("ball_query",) if sites else ())
            + tuple(f"ball_query_{s}" for s in sites))


def is_pointrcnn_model(model):
    from pdanet_tpu_torch.models.detectors.point_rcnn import PointRCNN

    return isinstance(model, PointRCNN)


def batch_frames(batch):
    """The frames of a device batch."""
    return next(iter(batch.values())).shape[0]


def describe_batch(batch):
    """What a device batch holds a frame: its points, or its voxels (the
    budget and the non-empty ones)."""
    if "voxels" not in batch:
        return f"{batch['points'].shape[1]} points of {batch['points'].shape[2]} features"
    return (f"at most {batch['voxels'].shape[1]} voxels of {batch['voxels'].shape[2]}, "
            f"non-empty {(batch['voxel_num_points'] > 0).sum(dim=1).tolist()}")


def voxel_frames(seed, n, classes):
    """``n`` of phase 9's LiDAR-like frames, all three KITTI classes in the
    points, the gt boxes of ``classes`` alone (the yaml's)."""
    rs = np.random.RandomState(seed)
    frames = []
    for _ in range(n):
        pts, boxes, names = kitti_like_frame(rs, list(KITTI_MEAN_SIZES),
                                             list(KITTI_MEAN_SIZES.values()))
        keep = np.isin(names, list(classes))
        frames.append((pts, boxes[keep], names[keep]))
    return frames


def voxel_batch(cfg, frames, training, dev, model=None):
    """LiDAR-like frames ``(points, boxes, names)`` through the yaml's point
    processors of the split (range mask, shuffle on the train split, the
    host voxelizer at the split's budget) and the collate: the device
    batch and the host milliseconds a frame."""
    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
    from pdanet_tpu_torch.datasets.processor.data_processor import DataProcessor
    from pdanet_tpu_torch.train import select_device_batch

    dp = DataProcessor(cfg.DATA_CONFIG.DATA_PROCESSOR, cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                       training=training, num_point_features=4)
    names = list(cfg.CLASS_NAMES)
    out, host_ms = [], []
    for pts, boxes, box_names in frames:
        gt = np.concatenate([boxes, [[names.index(n) + 1] for n in box_names]], 1)
        t0 = time.perf_counter()
        out.append(dp.forward({"points": pts, "gt_boxes": gt.astype(np.float32)}))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    batch = DatasetTemplate.collate_batch_static(out, cfg.DATA_CONFIG.MAX_GT_BOXES)
    return select_device_batch(batch, dev, model), host_ms


class RecordIoUShapes:
    """Records the shape of every self-IoU that ``batched_nms_candidates``
    (every detector's post-processing, the two-stage proposal layer) asks
    for, and each NMS walk's keep mask and its (valid, thresh), the kernels
    running as ever.  With ``keep_boxes`` it also keeps each IoU's input
    boxes; with ``feed`` (IoU matrices) it returns them in turn instead of
    computing the IoU."""

    def __init__(self, keep_boxes=False, feed=None):
        self.keep_boxes, self.feed = keep_boxes, None if feed is None else list(feed)

    def __enter__(self):
        from pdanet_tpu_torch.models.model_utils import model_nms_utils

        self.shapes, self.keeps, self.walks, self.boxes = [], [], [], []
        self.module = model_nms_utils
        self.orig = (model_nms_utils.boxes_iou_bev_batched_self,
                     model_nms_utils.greedy_nms_mask_batched)

        def iou(boxes):
            self.shapes.append(tuple(boxes.shape))
            if self.keep_boxes:
                self.boxes.append(boxes)
            if self.feed is not None:
                fed = self.feed.pop(0)
                require(fed.shape[:2] == boxes.shape[:2], f"fed IoU {tuple(fed.shape)} for "
                        f"candidates {tuple(boxes.shape)}")
                return fed.to(boxes.device)
            return self.orig[0](boxes)

        def walk(iou, valid, thresh):
            keep = self.orig[1](iou, valid, thresh)
            self.keeps.append(keep)
            self.walks.append((valid, thresh))
            return keep

        model_nms_utils.boxes_iou_bev_batched_self = iou
        model_nms_utils.greedy_nms_mask_batched = walk
        return self

    def __exit__(self, *exc):
        (self.module.boxes_iou_bev_batched_self,
         self.module.greedy_nms_mask_batched) = self.orig


@contextlib.contextmanager
def plain_iou_on(dev):
    """A CPU run's self-IoU (``batched_nms_candidates``) by the plain
    version on ``dev``, on the CPU run's own candidates, its NMS walk on the
    CPU as ever: the plain IoU takes the host ~17 s at K 4096, the card a
    fraction of a second."""
    from pdanet_tpu_torch.models.model_utils import model_nms_utils
    from pdanet_tpu_torch.ops.rotated_iou import boxes_iou_bev_batched_self_plain

    own = model_nms_utils.boxes_iou_bev_batched_self
    model_nms_utils.boxes_iou_bev_batched_self = (
        lambda boxes: boxes_iou_bev_batched_self_plain(boxes.to(dev)).to(boxes.device))
    try:
        yield
    finally:
        model_nms_utils.boxes_iou_bev_batched_self = own


def post_cfg_of(cfg):
    """The post-processing config the model's NMS reads: CenterPoint's
    head's own (``DENSE_HEAD.POST_PROCESSING``), else the model's."""
    if cfg.MODEL.NAME == "CenterPoint":
        return cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    return cfg.MODEL.POST_PROCESSING


def serve_ks(cfg):
    """The K of every self-IoU and walk a request runs: a two-stage model's
    proposal layer's and its final NMS's (at most its RoIs), CenterPoint's
    over its heads' top ``MAX_OBJ_PER_SAMPLE`` candidates each, else the
    post-processing's."""
    post = int(post_cfg_of(cfg).NMS_CONFIG.NMS_PRE_MAXSIZE)
    if cfg.MODEL.NAME == "CenterPoint":
        head = cfg.MODEL.DENSE_HEAD
        return {min(post, len(head.CLASS_NAMES_EACH_HEAD)
                    * int(head.POST_PROCESSING.MAX_OBJ_PER_SAMPLE))}
    if "ROI_HEAD" not in cfg.MODEL:
        return {post}
    test = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
    return {int(test.NMS_PRE_MAXSIZE), min(post, int(test.NMS_POST_MAXSIZE))}


def nms_candidates(out, post_cfg, column=None):
    """The NMS candidates of frame 0 as ``post_processing`` picks them: the
    ``NMS_PRE_MAXSIZE`` best anchors by score (the best class's, or class
    ``column``'s with ``MULTI_CLASSES_NMS``), stable order, and which of
    them clear ``SCORE_THRESH``."""
    import torch

    scores = torch.sigmoid(out["batch_cls_preds"][:1])
    scores = scores.max(dim=-1).values if column is None else scores[..., column]
    valid = torch.isfinite(scores) & (scores >= post_cfg.SCORE_THRESH)
    masked = torch.where(valid, scores, -torch.inf)
    K = min(int(post_cfg.NMS_CONFIG.NMS_PRE_MAXSIZE), scores.shape[1])
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :K]
    boxes = torch.gather(out["batch_box_preds"][:1], 1,
                         order[..., None].expand(1, K, 7)).contiguous()
    return boxes, torch.gather(valid, 1, order).contiguous(), int(valid.sum())


def proposal_candidates(first, nms_cfg):
    """Frame 0's proposal-layer candidates as ``batched_nms_candidates``
    picks them: the ``NMS_PRE_MAXSIZE`` best anchors by their best raw
    logit, stable order, all valid."""
    import torch

    scores = first["batch_cls_preds"][:1].max(dim=-1).values
    K = min(int(nms_cfg.NMS_PRE_MAXSIZE), scores.shape[1])
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :K]
    boxes = torch.gather(first["batch_box_preds"][:1], 1,
                         order[..., None].expand(1, K, 7)).contiguous()
    return boxes, torch.ones((1, K), dtype=torch.bool, device=boxes.device)


def kernel_candidates(cfg, out, served):
    """(e)'s inputs: (boxes, valid, thresh, what, suppress) for each K of
    the path, from frame 0 of a b1 request's forward ``out`` (a two-stage
    model's first stage): the proposal layer's TRAIN and TEST candidates,
    or the post-processing's (each class's with ``MULTI_CLASSES_NMS``);
    with ``out["final_forward"]`` (SECOND-IoU) also the final NMS's of the
    scored RoIs; for PV-RCNN the final NMS's of request 0's refined RoIs
    (``served``).  A forward without class logits (CenterPoint's decoded
    scores) gives the candidates that request 0's NMS was given, as
    ``served`` (``RecordIoUShapes`` of (a)) recorded them, and its walk
    must suppress some (``suppress``)."""
    import torch

    if "batch_cls_preds" not in out:
        (valid, thresh), boxes = served.walks[0], served.boxes[0]
        return [(boxes, valid, float(thresh), f"request 0's {int(valid.sum())} valid NMS "
                 f"candidates as its post-processing gave them", True)]
    if "ROI_HEAD" not in cfg.MODEL:
        post_cfg = cfg.MODEL.POST_PROCESSING
        rows = []
        multi = post_cfg.NMS_CONFIG.get("MULTI_CLASSES_NMS", False)
        for column in (range(len(cfg.CLASS_NAMES)) if multi else [None]):
            boxes, valid, n_valid = nms_candidates(out, post_cfg, column)
            what = "" if column is None else f"class {cfg.CLASS_NAMES[column]}'s "
            rows.append((boxes, valid, float(post_cfg.NMS_CONFIG.NMS_THRESH),
                         f"frame 0's {what}candidates, {n_valid} anchors of "
                         f"{out['batch_cls_preds'].shape[1]} over SCORE_THRESH", False))
        return rows
    rows = []
    for split in ("TRAIN", "TEST"):
        nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG[split]
        boxes, valid = proposal_candidates(out, nms_cfg)
        rows.append((boxes, valid, float(nms_cfg.NMS_THRESH),
                     f"frame 0's {split} proposal candidates of "
                     f"{out['batch_cls_preds'].shape[1]} anchors", False))
    if cfg.MODEL.NAME in PV_NAMES or is_parta2(cfg) or is_pointrcnn(cfg):
        # the final NMS of the refined RoIs
        K = min(int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE),
                int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE))
        i = next(i for i, b in enumerate(served.boxes) if b.shape[:2] == (1, K))
        (valid, thresh), boxes = served.walks[i], served.boxes[i]
        rows.append((boxes, valid, float(thresh), f"request 0's {int(valid.sum())} refined RoIs "
                     f"over SCORE_THRESH as its post-processing gave them", False))
    if "final_forward" in out:  # SECOND-IoU's NMS of its scored RoIs
        final, post_cfg = out["final_forward"], cfg.MODEL.POST_PROCESSING
        scores = torch.sigmoid(final["rcnn_iou"][:1].max(dim=-1).values)
        valid = final["roi_valid"][:1] & (scores >= post_cfg.SCORE_THRESH)
        K = min(int(post_cfg.NMS_CONFIG.NMS_PRE_MAXSIZE), scores.shape[1])
        order = torch.sort(torch.where(valid, scores, -torch.inf), dim=-1, descending=True,
                           stable=True).indices[:, :K]
        rows.append((torch.gather(final["batch_box_preds"][:1], 1,
                                  order[..., None].expand(1, K, 7)).contiguous(),
                     torch.gather(valid, 1, order).contiguous(),
                     float(post_cfg.NMS_CONFIG.NMS_THRESH),
                     f"frame 0's {int(valid.sum())} RoIs scored over SCORE_THRESH", False))
    return rows
def turns(kern, plain, plain_reps):
    """A kernel and its plain version timed in turns (kernel, plain, plain,
    kernel; with ``plain_reps`` 1, where a plain call takes up to a second,
    kernel, plain, kernel) under CUDA events, the kernel's medians of 20
    runs, the plain version's of ``plain_reps`` with no warm-up of its own
    (every caller has run the plain version on these inputs for its
    check): (kernel ms, plain ms), each the mean of its medians."""
    k1 = cuda_ms(kern, reps=20)
    plains = [cuda_ms(plain, reps=plain_reps, warmup=0) for _ in range(min(plain_reps, 2))]
    k2 = cuda_ms(kern, reps=20)
    return (k1 + k2) / 2, statistics.mean(plains)


def voxel_kernels(dev, boxes, valid, thresh, label, what, suppress=False, parent=None):
    """Phases 12-16 (e): the rotated self-IoU and the NMS walk on the path's
    own candidates ``boxes`` (1, K, 7) / ``valid`` (1, K) (frame 0 of a b1
    request, ``what`` says which) against their plain versions: the IoU
    within rtol 2e-4 / atol 2e-5, the keep mask equal (with ``suppress``,
    some valid candidate suppressed); CUDA-event times in turns (kernel,
    plain, plain, kernel), device times under the profiler and bounds from
    these candidates; with ``parent``, that tree's IoU kernel timed in
    turns beside this tree's.  Returns the two rows' numbers."""
    import torch

    from pdanet_tpu_torch.ops import nms, rotated_iou

    K = boxes.shape[1]
    got = rotated_iou.boxes_iou_bev_batched_self_cuda(boxes)
    want = rotated_iou.boxes_iou_bev_batched_self_plain(boxes)
    err = (got - want).abs().max().item()
    require(torch.allclose(got, want, rtol=2e-4, atol=2e-5),
            f"IoU K={K} on the {label} candidates outside rtol 2e-4 / atol 2e-5 ({err})")
    # no diagonal gate here: seeded weights decode boxes millimetres thin
    # and 70 m out, whose float32 clip leaves a self-IoU below 1 in the
    # plain version too (the kernel is held to the plain version above)
    diag_min = torch.diagonal(got, dim1=1, dim2=2).min().item()
    keep = nms.greedy_nms_mask_batched_cuda(got, valid, thresh)
    keep_p = nms.greedy_nms_mask_batched_plain(got, valid, thresh)
    require(torch.equal(keep, keep_p), f"{label} NMS K={K}: the keep mask differs from the "
            f"plain version")
    require(not suppress or int(keep.sum()) < int(valid.sum()),
            f"{label} NMS K={K}: no valid candidate suppressed")
    del want
    pairs = iou_pairs_needed(boxes)
    rows = {}
    plain_reps = 1 if K >= 4096 else 2  # the plain IoU takes ~0.2-0.9 s a call there
    iou_ms, iou_plain = turns(lambda: rotated_iou.boxes_iou_bev_batched_self_cuda(boxes),
                              lambda: rotated_iou.boxes_iou_bev_batched_self_plain(boxes),
                              plain_reps)
    iou_dev = kernel_device_ms(lambda: rotated_iou.boxes_iou_bev_batched_self_cuda(boxes),
                               "iou_self_kernel")
    if parent:
        vs_parent(f"IoU {label} K={K}", lambda: rotated_iou.boxes_iou_bev_batched_self_cuda(boxes),
                  lambda: parent.rotated_iou.boxes_iou_bev_batched_self_cuda(boxes), reps=20,
                  device_name="iou_self_kernel")
    bnd = bound((boxes.numel() + got.numel()) * 4, pairs * IOU_PAIR_OPS, F32_OPS_PER_S)
    rows["rotated_iou"] = dict(max_abs_err=err, ms=iou_ms, plain_ms=iou_plain, bound_ms=bnd[0],
                               bound_by=bnd[1], library_ms=None)
    print(f"{'rotated_iou':27s} {label} K={K} ({what}, {pairs} pairs whose circles "
          f"meet): max_abs_err {err:.3g}, diagonal at least {diag_min:.6g}; kernel "
          f"{iou_ms:.4f} ms (device "
          f"{fmt_ms(iou_dev)}), plain {iou_plain:.4f} ms; "
          f"bound {bnd[0]:.4f} ms ({bnd[1]}), kernel at {100 * bnd[0] / iou_ms:.1f} % of it")

    row_reads = int((K - 1 - torch.nonzero(keep)[:, 1]).sum())
    nms_ms, nms_plain = turns(lambda: nms.greedy_nms_mask_batched_cuda(got, valid, thresh),
                              lambda: nms.greedy_nms_mask_batched_plain(got, valid, thresh),
                              plain_reps)
    nms_dev = [kernel_device_ms(lambda: nms.greedy_nms_mask_batched_cuda(got, valid, thresh),
                                name) for name in ("nms_", "nms_mask_kernel", "nms_walk_kernel")]
    bnd = bound(row_reads * 4 + valid.numel() + keep.numel(), row_reads, F32_OPS_PER_S)
    rows["nms"] = dict(max_abs_err=0.0, ms=nms_ms, plain_ms=nms_plain, bound_ms=bnd[0],
                       bound_by=bnd[1], library_ms=None)
    print(f"{'nms':27s} {label} K={K} thresh {thresh:g}: keep mask equal, "
          f"{int(keep.sum())} kept of {int(valid.sum())} valid; kernel {nms_ms:.4f} ms "
          f"(device {fmt_ms(nms_dev[0])}: words {fmt_ms(nms_dev[1])}, walk "
          f"{fmt_ms(nms_dev[2])}), plain {nms_plain:.4f} ms; bound {bnd[0]:.5f} ms ({bnd[1]}, "
          f"the IoU rows right of {int(keep.sum())} kept boxes)")
    return rows


def pv_kernels(dev, first, label, suffix):
    """Phase 17 (e): FPS and each ball query of request 0 (``first``'s
    ``pv_picks``) on its own inputs against the plain versions: FPS equal
    (for PV-RCNN++ on SPC's collapsed cloud, and on the raw cloud with all
    but half as many points as picks collapsed onto its first point, so
    that the picks run out of distinct points), each source's ball query
    equal; CUDA-event times in turns, device times under the profiler and
    bounds from these inputs.  Returns ``[(row name, kernel, the key of
    its launches in ``counted_launches``, numbers)]``."""
    import torch

    from pdanet_tpu_torch.ops import ball_query, sampling

    picks, rows = first["pv_picks"], []
    xyz, npoint, _ = picks.fps[0]
    xyz = xyz.float().contiguous()
    N = xyz.shape[1]
    clouds = [("request 0's cloud", xyz)]
    spc = suffix.endswith("_pp")
    if spc:  # the raw points, all but npoint / 2 collapsed onto the first
        few = first["pv_points"].float().clone()
        few[:, npoint // 2:] = few[:, :1]
        clouds.append((f"the raw cloud with points {npoint // 2} on collapsed onto point 0",
                       few.contiguous()))
    for what, cloud in clouds:
        got = sampling.farthest_point_sample_cuda(cloud, npoint)
        want = sampling.farthest_point_sample_plain(cloud, npoint)
        distinct = int(torch.unique(cloud[0], dim=0).shape[0])
        require(torch.equal(got, want), f"{label} FPS {N} -> {npoint} on {what} ({distinct} "
                f"distinct points): indices differ from the plain version")
        print(f"{'fps':27s} {label} {N}->{npoint} on {what}: {distinct} distinct points, "
              f"indices equal, {int(torch.unique(got).numel())} distinct indices picked")
    fps_ms, fps_plain = turns(lambda: sampling.farthest_point_sample_cuda(xyz, npoint),
                              lambda: sampling.farthest_point_sample_plain(xyz, npoint), 2)
    fps_dev = kernel_device_ms(lambda: sampling.farthest_point_sample_cuda(xyz, npoint),
                               "fps_kernel")
    # per step and point: 3 sub, 3 mul, 2 add, the min and the argmax compare
    bnd = bound(xyz.numel() * 4 + npoint * 4, npoint * N * 10, F32_OPS_PER_S)
    print(f"{'fps':27s} {label} {N}->{npoint}: kernel {fps_ms:.4f} ms (device "
          f"{fmt_ms(fps_dev)}, {1e3 * fps_ms / (npoint - 1):.4f} us per serial step, launch "
          f"shape {sampling.fps_config(N)}), plain {fps_plain:.4f} ms; bound {bnd[0]:.4f} ms "
          f"({bnd[1]}), kernel at {100 * bnd[0] / fps_ms:.1f} % of it")
    rows.append((f"fps_spc{suffix}" if spc else f"fps_k{npoint}{suffix}", "fps", "fps",
                 dict(max_abs_err=0.0, ms=fps_ms, plain_ms=fps_plain, bound_ms=bnd[0],
                      bound_by=bnd[1], library_ms=None)))
    for radii, ks, sup, ctr, _, src in picks.ball:
        sup, ctr = sup.float().contiguous(), ctr.float().contiguous()
        got = ball_query.ball_query_multi_cuda(radii, ks, sup, ctr)
        want = ball_query.ball_query_multi_plain(radii, ks, sup, ctr)
        for r, (g, w) in enumerate(zip(got, want)):
            require(torch.equal(g, w), f"{label} ball query {src} (radius {radii[r]}) differs "
                    f"from the plain version")
        scan, in_reach = ball_query_work(radii, ks, sup, ctr)
        bq_ms, bq_plain = turns(lambda: ball_query.ball_query_multi_cuda(radii, ks, sup, ctr),
                                lambda: ball_query.ball_query_multi_plain(radii, ks, sup, ctr), 2)
        # per point of a tile in reach, before the first-K scan ends: the
        # distance (3 sub, 3 mul, 2 add) and a compare per radius
        bnd = bound((sup.numel() + ctr.numel() + sum(w.numel() for w in want)) * 4,
                    in_reach * (8 + len(radii)), F32_OPS_PER_S)
        n_far = int((sup[..., 0] >= 1e6).sum())
        print(f"{'ball_query':27s} {label} {src}: N={sup.shape[1]} ({n_far} rows at "
              f"FAR_SENTINEL) M={ctr.shape[1]} radii {radii} K {ks}, equal; kernel "
              f"{bq_ms:.4f} ms, plain {bq_plain:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), kernel "
              f"at {100 * bnd[0] / bq_ms:.1f} % of it")
        print_ball_query_work(f"{label} {src}", radii, ks, sup, ctr, (scan, in_reach))
        rows.append((f"ball_query_{src}{suffix}", "ball_query", f"ball_query_{src}",
                     dict(max_abs_err=0.0, ms=bq_ms, plain_ms=bq_plain, bound_ms=bnd[0],
                          bound_by=bnd[1], library_ms=None)))
    return rows


def sparse_levels(model, cpu_model, requests, label="SECOND"):
    """Phase 13 (a): the active sites of every level of the sparse backbone
    in each request, and which levels filled their budget; then the first
    request's coordinates and neighbour tables of every level on the card
    equal to the CPU's (``geometry``: the sorted-key search, the dedup and
    the compaction of each level)."""
    import torch

    with torch.inference_mode():
        for i, batch in enumerate(requests):
            levels = model.backbone_3d.geometry(batch["voxel_coords"])
            sites = {name: lv["valid"].sum(dim=1).tolist()
                     for name, lv in zip(SPARSE_LEVELS, levels)}
            full = [name for name, lv in zip(SPARSE_LEVELS, levels)
                    if bool((lv["valid"].sum(dim=1) == lv["valid"].shape[1]).any())]
            budgets = {name: lv["valid"].shape[1] for name, lv in zip(SPARSE_LEVELS, levels)}
            print(f"{label} request {i}: active sites a level {sites} of budgets {budgets}; "
                  f"levels that filled their budget: {full or 'none'}")
        card = model.backbone_3d.geometry(requests[0]["voxel_coords"])
        cpu = cpu_model.backbone_3d.geometry(requests[0]["voxel_coords"].cpu())
    taps = {}
    for name, g, c in zip(SPARSE_LEVELS, card, cpu):
        for key, want in c.items():
            require(torch.equal(g[key].cpu(), want), f"{label} {name}: {key} on the card "
                    f"differs from the CPU's")
        table = c["subm"] if "subm" in c else c["down"]
        taps[name] = round(float((table >= 0).sum(dim=-1)[c["valid"]].float().mean()), 2)
    print(f"{label} b1 frame, card vs CPU: every level's coordinates and neighbour tables "
          f"equal; mean taps found a site (submanifold table, conv_out's strided) {taps}")


def anchors_card_vs_cpu(cfg, model, weights, template, requests, results, label):
    """Phases 12, 13 and 20b (a): request 0's frame in float32 on the card
    (kernels) against the CPU (plain versions; the CPU's self-IoU by the
    plain version on the card, ``plain_iou_on``): logits within 2e-3, boxes
    and headings within 1e-3 (a heading pi apart only where the direction
    bins or the period's fold tie), the detections paired box for box;
    for a sparse backbone its levels (``sparse_levels``).  Returns the
    card's forward."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors import get_post_processor

    b1 = requests[0]
    with torch.inference_mode():
        out_card = model.forward_batch(b1)
    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template, device="cpu")
    cpu_model.load_state_dict(weights)
    cpu_batch = {k: v.cpu() for k, v in b1.items()}
    t0 = time.perf_counter()
    with torch.inference_mode(), plain_iou_on(next(iter(b1.values())).device):
        out_cpu = cpu_model.eval().forward_batch(cpu_batch)
        post_cpu = get_post_processor(cfg.MODEL.NAME)(out_cpu, cfg.MODEL)
    cpu_s = time.perf_counter() - t0
    logit_err = (out_card["batch_cls_preds"].cpu() - out_cpu["batch_cls_preds"]).abs().max().item()
    # a heading is compared modulo the direction bins' period: where the two
    # bins' logits nearly tie, or the raw heading lies on a fold of the
    # period, rounding picks the other turn, pi apart
    head = cfg.MODEL.DENSE_HEAD
    period = 2 * np.pi / head.NUM_DIR_BINS
    bc, bg = out_cpu["batch_box_preds"], out_card["batch_box_preds"].cpu()
    box_err = ((bg[..., :6] - bc[..., :6]).abs() / bc[..., :6].abs().clamp(min=1.0)).max().item()
    turn = torch.remainder(bg[..., 6] - bc[..., 6] + period / 2, period) - period / 2
    head_err = turn.abs().max().item()
    flipped = (bg[..., 6] - bc[..., 6]).abs() > period / 2
    dir_cpu = out_cpu["dir_cls_preds"].reshape(1, -1, head.NUM_DIR_BINS)
    bin_tie = (dir_cpu[..., 0] - dir_cpu[..., 1]).abs()
    raw = (out_cpu["box_preds"].reshape(1, -1, 7)[..., 6] + cpu_model.anchors_flat[:, 6]
           - head.DIR_OFFSET) / period + head.DIR_LIMIT_OFFSET
    fold_tie = (raw - torch.round(raw)).abs()
    tie = torch.minimum(bin_tie / 1e-4, fold_tie / 1e-4)[flipped]  # <= 1: a tie
    pairs, n_g, n_c, gap_c, gap_s = match_detections(results[0][2], post_cpu)
    print(f"{label} float32 frame, card vs CPU ({cpu_s:.1f} s on the CPU): logits within "
          f"{logit_err:.3g}; boxes within {box_err:.3g} of max(1, |value|), headings within "
          f"{head_err:.3g} modulo pi; {int(flipped.sum())} of {flipped.numel()} anchors pi "
          f"apart (direction logits within {bin_tie[flipped].tolist()}, raw headings "
          f"{fold_tie[flipped].tolist()} periods from a fold); detections {n_g} vs {n_c}, {pairs} "
          f"paired by mutual nearest centre (largest centre distance {gap_c:.3g} m, score "
          f"{gap_s:.3g})")
    require(logit_err <= 2e-3, f"{label} logits card vs CPU {logit_err} > 2e-3")
    require(box_err <= 1e-3 and head_err <= 1e-3,
            f"{label} boxes card vs CPU {box_err} / {head_err} > 1e-3")
    require(not len(tie) or tie.max().item() <= 1.0,
            f"{label}: a heading turned by pi card vs CPU with no tie (direction logits "
            "or the period's fold within 1e-4)")
    require(n_g == n_c == pairs and gap_c <= 1e-3 and gap_s <= 1e-4,
            f"{label} float32 detections card vs CPU not paired box for box")
    if hasattr(getattr(model, "backbone_3d", None), "geometry"):  # a sparse backbone
        sparse_levels(model, cpu_model, requests)
    return out_card


def center_card_vs_cpu(cfg, model, weights, template, requests, results, label):
    """Phase 16 (a): request 0's frame in float32 on the card (kernels)
    against the CPU (plain versions): each head's maps within
    ``CENTER_MAPS_TOL`` of max(1, |value|) of the CPU's own forward (the
    heatmap after the sigmoid too); then on the card's maps (its sigmoided heatmap
    and box maps) the CPU's top-K indices and classes equal to the card's,
    its decode within 1e-4 of max(1, |value|) with the same valid
    candidates, and its post-processing of the card's decoded candidates
    (the plain IoU and walk) paired box for box with the card's request
    (equal counts, centres within 1e-5 m, scores equal); the pairing of the
    CPU's own forward's detections is printed beside it; the sparse
    backbone's levels (``sparse_levels``).  Returns the card's forward."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.dense_heads import center_head as CH
    from pdanet_tpu_torch.models.detectors import get_post_processor
    from pdanet_tpu_torch.models.model_utils import centernet_utils as CU

    b1 = requests[0]
    post_fn = get_post_processor(cfg.MODEL.NAME)
    with torch.inference_mode():
        out_card = model.forward_batch(b1)
    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template, device="cpu")
    cpu_model.load_state_dict(weights)
    cpu_batch = {k: v.cpu() for k, v in b1.items()}
    t0 = time.perf_counter()
    with torch.inference_mode():
        out_cpu = cpu_model.eval().forward_batch(cpu_batch)
        post_own = post_fn(out_cpu, cfg.MODEL)
    cpu_s = time.perf_counter() - t0
    map_err, hm_err = {}, 0.0
    for card_maps, cpu_maps in zip(out_card["pred_dicts"], out_cpu["pred_dicts"]):
        for key, want in cpu_maps.items():
            err = ((card_maps[key].cpu() - want).abs().max() / want.abs().max().clamp(min=1.0))
            map_err[key] = max(map_err.get(key, 0.0), err.item())
        hm_err = max(hm_err, (torch.sigmoid(card_maps["hm"]).cpu()
                              - torch.sigmoid(cpu_maps["hm"])).abs().max().item())
    require(max(map_err.values()) <= CENTER_MAPS_TOL and hm_err <= CENTER_MAPS_TOL,
            f"{label} head maps card vs CPU {map_err}, heatmap {hm_err} > {CENTER_MAPS_TOL}")

    # the decode and the post-processing on the card's own maps
    head = cfg.MODEL.DENSE_HEAD
    K = int(head.POST_PROCESSING.MAX_OBJ_PER_SAMPLE)
    with torch.inference_mode():
        fed = []
        for card_maps in out_card["pred_dicts"]:
            hm_card = torch.sigmoid(card_maps["hm"])
            on_card = [t.cpu() for t in CU.topk_heatmap(hm_card, K)]
            on_cpu = CU.topk_heatmap(hm_card.cpu(), K)
            for name, g, c in zip(("score", "inds", "class", "ys", "xs"), on_card, on_cpu):
                require(torch.equal(g, c), f"{label} top-K {name} on the card's heatmap differs "
                        f"from the CPU's")
            fed.append({k: v.cpu() for k, v in card_maps.items()})
        boxes, scores, labels, valid = CH.generate_predicted_boxes(
            fed, cpu_model.class_id_mapping_each_head, head.POST_PROCESSING,
            np.asarray(cpu_model.point_cloud_range, np.float32),
            np.asarray(cpu_model.voxel_size, np.float32), cpu_model.feature_map_stride,
            cpu_model.head_order)
        card_boxes = out_card["batch_box_preds"].cpu()
        box_err = ((card_boxes - boxes).abs() / boxes.abs().clamp(min=1.0)).max().item()
        require(torch.equal(out_card["batch_valid_preds"].cpu(), valid)
                and torch.equal(out_card["batch_label_preds"].cpu(), labels)
                and box_err <= 1e-4,
                f"{label} decode on the card's maps: boxes within {box_err}, valid / labels "
                f"differ")
        post_fed = post_fn({k: out_card[k].cpu() for k in (
            "batch_box_preds", "batch_score_preds", "batch_label_preds", "batch_valid_preds")},
            cfg.MODEL)
    pairs, n_g, n_c, gap_c, gap_s = match_detections(results[0][2], post_fed)
    own = match_detections(results[0][2], post_own)
    n_valid = int(out_card["batch_valid_preds"].sum())
    print(f"{label} float32 frame, card vs CPU ({cpu_s:.1f} s on the CPU): head maps within "
          f"{ {k: float(f'{v:.3g}') for k, v in map_err.items()} } of max(1, |value|), heatmap "
          f"within {hm_err:.3g}; on the card's maps: top-{K} indices equal, decode within "
          f"{box_err:.3g}, {n_valid} valid candidates; detections {n_g} vs {n_c}, {pairs} paired "
          f"(largest centre distance {gap_c:.3g} m, score {gap_s:.3g}); the CPU's own forward: "
          f"{own[2]} detections, {own[0]} paired with the card's (centres within {own[3]:.3g} "
          f"m, scores {own[4]:.3g})")
    require(n_g == n_c == pairs and gap_c <= 1e-5 and gap_s == 0.0,
            f"{label} float32 detections on the card's candidates not paired box for box")
    sparse_levels(model, cpu_model, requests, label)
    return out_card


def vrcnn_queries(model, out, rois):
    """The RoI head's voxel query of ``rois`` (B, R, 7) on the forward's
    sparse levels: the (B, G, 3) grid points and, a level, ``query``'s
    ``(table, pos_idx, valid_k, empty, rel)``."""
    from pdanet_tpu_torch.models.roi_heads.voxelrcnn_head import get_dense_grid_points

    head = model.roi_head
    grid_size, voxel_size, pc_range = head.geometry
    grid = get_dense_grid_points(rois, head.grid).reshape(rois.shape[0], -1, 3)
    return grid, {src: getattr(head, f"pool_{src}").query(
        out["multi_scale_3d_features"][src][0], head.strides[src], grid, voxel_size, pc_range,
        grid_size) for src in head.sources}


def roi_traffic(cfg, model, requests, keeps, label):
    """Phase 14 (a): what the served requests gave the second stage.  The
    proposal layer's walks (``keeps``, at the TEST K) must suppress some
    candidates; per request the RoIs kept, and per level the grid points
    whose window is empty and whose window is full (``NSAMPLE`` hits, so
    that the first-``NSAMPLE`` pick and the max over slots choose): some
    level must hold full windows."""
    import torch

    K_prop = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE)
    n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE)
    kept = [k.sum(dim=1).tolist() for k in keeps if k.shape[1] == K_prop]
    print(f"{label} proposal layer: candidates kept by the walk at K {K_prop} {kept}")
    require(kept and any(n < K_prop for frame in kept for n in frame),
            f"{label}: the proposal layer's walk suppressed no candidate")
    full = {}
    with torch.inference_mode():
        for i, batch in enumerate(requests):
            out = model.forward_batch(batch)
            _, queries = vrcnn_queries(model, out, out["rois"])
            nsample = {src: q[2].shape[-1] for src, q in queries.items()}
            hits = {src: q[2].sum(dim=-1) for src, q in queries.items()}
            for src in queries:
                full[src] = full.get(src, 0) + int((hits[src] == nsample[src]).sum())
            print(f"{label} request {i}: RoIs kept by the proposal layer "
                  f"{out['roi_valid'].sum(dim=1).tolist()} of {n_rois}; of "
                  f"{queries['x_conv2'][3].shape[1]} grid points a frame, a level: empty windows "
                  f"{ {src: q[3].sum(dim=1).tolist() for src, q in queries.items()} }, full "
                  f"windows ({nsample} hits) "
                  f"{ {src: (h == nsample[src]).sum(dim=1).tolist() for src, h in hits.items()} }, "
                  f"mean hits { {src: round(float(h.float().mean()), 2) for src, h in hits.items()} }")
            del out, queries, hits
    require(any(full.values()), f"{label}: no grid point's window was full on any level")


def vrcnn_card_vs_cpu(cfg, model, weights, template, requests, results, label, gt):
    """Phase 14 (a): request 0's frame on the card against the CPU's plain
    path.  The whole forward on the CPU gives the first stage's logits
    (within 2e-3) and the agreement of its proposals; then each stage on
    the card's own inputs, so that a float32 difference upstream moves no
    index: the proposal layer on the card's first-stage outputs (keep mask
    and RoIs equal), the voxel query of the card's grid points on the
    card's sparse levels (every level's table, hits and empty windows
    equal), the RoI head on the card's levels and grid points
    (``rcnn_cls`` / ``rcnn_reg`` within 2e-3), the refined boxes'
    post-processing (the detections paired box for box with the card's
    request).  Then the voxel query and pool of RoIs placed on the frame's
    gt boxes ``gt`` (1, M, 8), whose windows hold the objects' sites:
    tables and hits equal, pooled features within 2e-3, and full windows
    on every level.  Returns the card's first-stage forward."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors.second import SECOND
    from pdanet_tpu_torch.models.detectors.voxel_rcnn import post_processing
    from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT

    b1 = requests[0]
    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
    with torch.inference_mode():
        with RecordIoUShapes() as rec_card:
            out_card = model.forward_batch(b1)
        first_card = SECOND.forward(model, b1["voxels"], b1["voxel_coords"],
                                    b1["voxel_num_points"])
        grid_card, q_card = vrcnn_queries(model, out_card, out_card["rois"])
    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template, device="cpu")
    cpu_model.load_state_dict(weights)
    cpu_model.eval()
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else tuple(x.cpu() for x in t)  # noqa: E731
    t0 = time.perf_counter()
    dev = b1["voxels"].device
    with torch.inference_mode(), plain_iou_on(dev), RecordIoUShapes() as rec_cpu:
        out_cpu = cpu_model.forward_batch({k: v.cpu() for k, v in b1.items()})
    cpu_s = time.perf_counter() - t0
    logit_err = (out_card["cls_preds"].cpu() - out_cpu["cls_preds"]).abs().max().item()
    whole_keep = torch.equal(rec_card.keeps[0].cpu(), rec_cpu.keeps[0])
    whole_rois = (out_card["rois"].cpu() - out_cpu["rois"]).abs().max().item()
    require(logit_err <= 2e-3, f"{label} first-stage logits card vs CPU {logit_err} > 2e-3")

    with torch.inference_mode():
        with plain_iou_on(dev), RecordIoUShapes() as rec_fed:
            props = RHT.proposal_layer(cpu(first_card["batch_cls_preds"]),
                                       cpu(first_card["batch_box_preds"]), nms_cfg)
        require(torch.equal(rec_fed.keeps[0], rec_card.keeps[0].cpu()),
                f"{label} proposal keep mask card vs CPU (the card's first stage fed)")
        for key in ("rois", "roi_labels", "roi_valid"):
            require(torch.equal(props[key], out_card[key].cpu()),
                    f"{label} proposals: {key} card vs CPU (the card's first stage fed)")
        ms = {k: cpu(v) for k, v in out_card["multi_scale_3d_features"].items()}
        fed = {"multi_scale_3d_features": ms}
        head = cpu_model.roi_head
        grid_size, voxel_size, pc_range = head.geometry

        def queries_equal(grid, queries, what):
            """Every level's voxel query of ``grid`` on the CPU equal to the
            card's ``queries``: mean taps found a site, mean hits kept and
            full windows a level."""
            taps, hits, full = {}, {}, {}
            for src, q in queries.items():
                q_cpu = getattr(head, f"pool_{src}").query(ms[src][0], head.strides[src],
                                                           grid.cpu(), voxel_size, pc_range,
                                                           grid_size)
                for name, g, c in zip(("table", "pos_idx", "valid_k", "empty"), q, q_cpu):
                    if name == "pos_idx":  # the taps picked, where they are hits
                        g, c = torch.where(q[2], g, -1).cpu(), torch.where(q_cpu[2], c, -1)
                    require(torch.equal(g.cpu(), c), f"{label} {src} voxel query of {what}: "
                            f"{name} card vs CPU (the card's grid points and sites fed)")
                n_hits = q_cpu[2].sum(dim=-1)
                taps[src] = round(float((q_cpu[0] >= 0).sum(dim=-1).float().mean()), 1)
                hits[src] = round(float(n_hits.float().mean()), 2)
                full[src] = int((n_hits == q_cpu[2].shape[-1]).sum())
            return taps, hits, full

        taps, hits, _ = queries_equal(grid_card, q_card, "the proposals")
        B, R = out_card["rois"].shape[:2]
        rcnn_cls, rcnn_reg = head.refine(head.pool(ms, grid_card.cpu()).reshape(B, R, -1))
        cls_err = (rcnn_cls - out_card["rcnn_cls"].cpu()).abs().max().item()
        reg_err = (rcnn_reg - out_card["rcnn_reg"].cpu()).abs().max().item()
        require(cls_err <= 2e-3 and reg_err <= 2e-3,
                f"{label} rcnn_cls / rcnn_reg card vs CPU {cls_err} / {reg_err} > 2e-3")
        fed.update(batch_cls_preds=rcnn_cls, roi_labels=props["roi_labels"],
                   roi_valid=props["roi_valid"],
                   batch_box_preds=RHT.decode_roi_boxes(props["rois"], rcnn_reg,
                                                        cpu_model.roi_box_coder))
        post_cpu = post_processing(fed, cfg.MODEL)
        gt_rois = gt[:, gt[0, :, 7] > 0, :7].contiguous()
        grid_gt, q_gt = vrcnn_queries(model, out_card, gt_rois)
        gt_taps, gt_hits, gt_full = queries_equal(grid_gt, q_gt, "the gt boxes")
        pooled_err = (head.pool(ms, grid_gt.cpu()) - model.roi_head.pool(
            out_card["multi_scale_3d_features"], grid_gt).cpu()).abs().max().item()
    print(f"{label} RoIs on frame 0's {gt_rois.shape[1]} gt boxes, card vs CPU: every level's "
          f"voxel query equal (mean taps found a site {gt_taps}, mean hits kept {gt_hits}, "
          f"full windows {gt_full} of {grid_gt.shape[1]} grid points), pooled features within "
          f"{pooled_err:.3g}")
    require(pooled_err <= 2e-3, f"{label} pooled features on the gt boxes card vs CPU "
            f"{pooled_err} > 2e-3")
    require(all(gt_full.values()), f"{label}: a level filled no window on the gt boxes "
            f"{gt_full}")
    pairs, n_g, n_c, gap_c, gap_s = match_detections(results[0][2], post_cpu)
    print(f"{label} float32 frame, card vs CPU (the whole forward {cpu_s:.1f} s on the CPU): "
          f"first-stage logits within {logit_err:.3g}; the whole CPU forward's proposal keep "
          f"mask {'equal' if whole_keep else 'different'}, its RoIs within {whole_rois:.3g}; "
          f"on the card's inputs: the proposal keep mask and RoIs equal, every level's voxel "
          f"query (tables, first-{head.pool_x_conv2.nsample} hits, empty windows) equal (mean "
          f"taps found a site {taps}, mean hits kept {hits} of {grid_card.shape[1]} grid "
          f"points), rcnn_cls within {cls_err:.3g}, rcnn_reg within {reg_err:.3g}; detections "
          f"{n_g} vs {n_c}, {pairs} paired (largest centre distance {gap_c:.3g} m, score "
          f"{gap_s:.3g})")
    require(n_g == n_c == pairs and gap_c <= 1e-3 and gap_s <= 1e-4,
            f"{label} float32 detections card vs CPU not paired box for box")
    return first_card


def pv_card_vs_cpu(cfg, model, weights, template, requests, results, label, gt):
    """Phase 17 (a): request 0's frame on the card against the CPU's plain
    path, each stage on the card's own inputs, so that a float32
    difference upstream moves no index: the first stage on the CPU (its
    logits within 2e-3); the proposal layer on the card's first-stage
    outputs (keep mask and RoIs equal; its plain IoU on the card,
    ``plain_iou_on``); the VSA on the card's raw points,
    levels, BEV map and RoIs (the keypoint indices equal, each source's
    ball-query indices equal); the point head on the card's keypoint
    features; the RoI head on the card's keypoints, weighted features and
    RoIs (the grid pool's ball-query indices equal); the refined boxes'
    post-processing (the detections paired box for box with the card's
    request); the RoI head on RoIs placed on the frame's gt boxes ``gt``
    (1, M, 8), where the keypoints lie (the grid pool's indices equal,
    some balls holding keypoints).  Each source's pooled features, the
    fused ones, the point scores and the RoI head's outputs are within
    ``PV_STAGE_TOL`` of max(1, |value|) (``pv_stage_gaps``); the card's
    stages with TF32 on, on the same inputs (the control), exceed it.
    PV-RCNN++'s three-NN searches (plain PyTorch on both devices, billions
    of distances a frame) are the card's, fed to the CPU.  Returns the
    card's first-stage forward, request 0's FPS and ball queries as
    ``pv_picks`` (``RecordPicks``) beside it."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors.pv_rcnn import BEV_STRIDE
    from pdanet_tpu_torch.models.detectors.second import SECOND
    from pdanet_tpu_torch.models.detectors.voxel_rcnn import post_processing
    from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT

    b1 = requests[0]
    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
    gt_rois = gt[:, gt[0, :, 7] > 0, :7].contiguous()
    with torch.inference_mode():
        with RecordPicks() as card:
            out_card = model.forward_batch(b1)
        first_card = SECOND.forward(model, b1["voxels"], b1["voxel_coords"],
                                    b1["voxel_num_points"])
        kp = out_card["point_coords"]
        weighted = out_card["point_features"] * out_card["point_cls_scores"][..., None]
        with RecordPicks() as card_gt:
            gt_card = model.roi_head(kp, weighted, gt_rois)
    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template, device="cpu")
    cpu_model.load_state_dict(weights)
    cpu_model.eval()
    cpu_b1 = {k: v.cpu() for k, v in b1.items()}
    t0 = time.perf_counter()
    with torch.inference_mode():
        first_cpu = SECOND.forward(cpu_model, cpu_b1["voxels"], cpu_b1["voxel_coords"],
                                   cpu_b1["voxel_num_points"])
    cpu_s = time.perf_counter() - t0
    logit_err = (first_card["cls_preds"].cpu() - first_cpu["cls_preds"]).abs().max().item()
    require(logit_err <= 2e-3, f"{label} first-stage logits card vs CPU {logit_err} > 2e-3")

    pfe = cpu_model.pfe
    queried = [b[5] for b in card.ball]  # the sites, in call order
    require(len(card.fps) == 1 and sorted(queried) == sorted(ball_query_sites(model)),
            f"{label}: {len(card.fps)} FPS and the ball queries at {queried} in a request, "
            f"want 1 and one at each of {ball_query_sites(model)}")
    t0 = time.perf_counter()
    with torch.inference_mode():
        with plain_iou_on(b1["voxels"].device):
            props = RHT.proposal_layer(first_card["batch_cls_preds"].cpu(),
                                       first_card["batch_box_preds"].cpu(), nms_cfg)
        for key in ("rois", "roi_labels", "roi_valid"):
            require(torch.equal(props[key], out_card[key].cpu()),
                    f"{label} proposals: {key} card vs CPU (the card's first stage fed)")
        ms = {k: tuple(t.cpu() for t in v) for k, v in first_card["multi_scale_3d_features"].items()}
        with RecordPicks(feed={"nn": card.picks()["nn"]}) as cpu:
            vsa = pfe(cpu_b1["points"], ms, {}, first_card["spatial_features"].cpu(), BEV_STRIDE,
                      rois=props["rois"])
            head_in = (out_card["point_features_before_fusion"]
                       if cpu_model.point_cfg.get("USE_POINT_FEATURES_BEFORE_FUSION", False)
                       else out_card["point_features"]).cpu()
            scores = torch.sigmoid(cpu_model.point_head(head_in)).max(dim=-1).values
            rcnn_cls, rcnn_reg = cpu_model.roi_head(kp.cpu(), weighted.cpu(),
                                                    out_card["rois"].cpu())
        with RecordPicks(feed={"nn": card_gt.picks()["nn"]}) as cpu_gt:
            gt_cpu = cpu_model.roi_head(kp.cpu(), weighted.cpu(), gt_rois.cpu())
        require(torch.equal(cpu.fps[0][2], card.fps[0][2].cpu()),
                f"{label}: the keypoint indices card vs CPU")
        for src, c, g in zip(queried, cpu.ball, card.ball):
            for r, (ci, gi) in enumerate(zip(c[4], g[4])):
                require(torch.equal(ci, gi.cpu()), f"{label} {src} ball query (radius "
                        f"{c[0][r]}) indices card vs CPU (the card's inputs fed)")
        for c, g in zip(cpu_gt.ball, card_gt.ball):
            for r, (ci, gi) in enumerate(zip(c[4], g[4])):
                require(torch.equal(ci, gi.cpu()), f"{label} RoI grid pool on the gt boxes: "
                        f"ball query (radius {c[0][r]}) indices card vs CPU")
        want = {"point_features_before_fusion": vsa["point_features_before_fusion"],
                "point_features": vsa["point_features"], "point_cls_scores": scores,
                "rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg, "gt": gt_cpu}
        errs = pv_stage_gaps(pfe.source_channels, {**out_card, "gt": gt_card}, want)
        fed = {"batch_cls_preds": rcnn_cls, "roi_labels": props["roi_labels"],
               "roi_valid": props["roi_valid"],
               "batch_box_preds": RHT.decode_roi_boxes(props["rois"], rcnn_reg,
                                                       cpu_model.roi_box_coder)}
        post_cpu = post_processing(fed, cfg.MODEL)
    stage_s = time.perf_counter() - t0
    # the control: the card's stages with TF32 on in cuDNN and cuBLAS, on
    # the inputs the CPU was given
    with torch.inference_mode(), tf32_on():
        control = model.pfe(b1["points"], first_card["multi_scale_3d_features"], {},
                            first_card["spatial_features"], BEV_STRIDE, rois=out_card["rois"])
        control["point_cls_scores"] = torch.sigmoid(model.point_head(
            head_in.to(b1["points"].device))).max(dim=-1).values
        control["rcnn_cls"], control["rcnn_reg"] = model.roi_head(kp, weighted, out_card["rois"])
        control["gt"] = model.roi_head(kp, weighted, gt_rois)
    control_errs = pv_stage_gaps(pfe.source_channels, control, want)

    def grouped(ball):  # share of centres whose ball holds two or more points, a radius
        return [round(float((o[..., 1:] != o[..., :1]).any(-1).float().mean()), 3)
                for o in ball[4]]

    sentinel = {src: int((g[2][..., 0] >= 1e6).sum()) for src, g in zip(queried, card.ball)}
    shares = {src: grouped(g) for src, g in zip(queried, card.ball)}
    gt_shares = grouped(card_gt.ball[0]) if card_gt.ball else []
    pairs, n_g, n_c, gap_c, gap_s = match_detections(results[0][2], post_cpu)
    nn_note = ", its three-NN searches the card's" if card.nn else ""
    print(f"{label} float32 frame, card vs CPU (the first stage {cpu_s:.1f} s, the rest "
          f"{stage_s:.1f} s on the CPU{nn_note}): "
          f"first-stage logits within {logit_err:.3g}; on the card's inputs: the proposals "
          f"equal, the {card.fps[0][1]} keypoint indices equal, the ball-query indices of "
          f"{queried} equal (support rows at FAR_SENTINEL {sentinel}; share of centres whose "
          f"ball holds two or more points, a radius {shares}); detections {n_g} vs {n_c}, "
          f"{pairs} paired (largest centre distance {gap_c:.3g} m, score {gap_s:.3g}); RoIs on "
          f"frame 0's {gt_rois.shape[1]} gt boxes: the grid pool's ball-query indices equal "
          f"(share grouping two or more keypoints {gt_shares})")
    for what, gaps in (("TF32 off", errs),
                       ("TF32 on in cuDNN and cuBLAS, the control", control_errs)):
        print(f"{label} stages card vs CPU, {what}: largest differences of max(1, |value|) "
              f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} }; over PV_STAGE_TOL "
              f"{PV_STAGE_TOL}: {sorted(k for k, v in gaps.items() if not v <= PV_STAGE_TOL)}")
    bad = {k: v for k, v in errs.items() if not v <= PV_STAGE_TOL}
    require(not bad, f"{label} keypoint features, scores and RCNN outputs card vs CPU over "
            f"{PV_STAGE_TOL} of max(1, |value|): {bad}")
    require(max(control_errs.values()) > PV_STAGE_TOL, f"{label}: PV_STAGE_TOL {PV_STAGE_TOL} "
            f"passes the control's stages (TF32 on) too: {control_errs}")
    require(not gt_shares or max(gt_shares) > 0, f"{label}: no grid point on the gt boxes "
            f"grouped two keypoints")
    require(n_g == n_c == pairs and gap_c <= 1e-3 and gap_s <= 1e-4,
            f"{label} float32 detections card vs CPU not paired box for box")
    first_card.update(pv_picks=card, pv_points=b1["points"][..., :3])
    return first_card


def pv_stage_gaps(source_channels, got, want):
    """``{stage: largest |got - want| / max(1, max |want|)}`` of PV-RCNN's
    stages (``want`` the CPU's): each source's pooled keypoint features,
    the fused ones, the point scores, ``rcnn_cls`` / ``rcnn_reg``, and the
    RoI head's outputs on the gt boxes (``gt``)."""
    def gap(g, w):
        return ((g.cpu() - w).abs().max() / w.abs().max().clamp(min=1.0)).item()

    gaps, start = {}, 0
    for src, width in source_channels.items():
        gaps[src] = gap(got["point_features_before_fusion"][..., start:start + width],
                        want["point_features_before_fusion"][..., start:start + width])
        start += width
    gaps["fused"] = gap(got["point_features"], want["point_features"])
    gaps["point scores"] = gap(got["point_cls_scores"], want["point_cls_scores"])
    for key in ("rcnn_cls", "rcnn_reg"):
        gaps[key] = gap(got[key], want[key])
    gaps["gt boxes' rcnn"] = max(gap(g, w) for g, w in zip(got["gt"], want["gt"]))
    return gaps


def is_pointrcnn(cfg):
    """Whether the yaml's model is PointRCNN (over the PointNet++ backbone)."""
    from pdanet_tpu_torch.models.detectors import resolve_detector_name

    return resolve_detector_name(cfg.MODEL) == "PointRCNN"


def is_parta2(cfg):
    """Whether the yaml's model is Part-A2 or Part-A2-free (MODEL.NAME
    PointRCNN over a UNet)."""
    from pdanet_tpu_torch.models.detectors import resolve_detector_name

    return resolve_detector_name(cfg.MODEL) in ("PartA2Net", "PartA2Free")


def parta2_card_vs_cpu(cfg, model, weights, template, requests, results, label, gt):
    """Phase 18 (a): request 0's frame on the card against the CPU's plain
    path.  The first stage whole on each device: the UNet's voxel features
    and the point head's outputs within ``PARTA2_STAGE_TOL`` of max(1,
    |value|), Part-A2's anchor logits within 2e-3.  Then each stage on the
    card's own inputs, so that a float32 difference upstream moves no
    index: the proposal layer on the card's first stage (keep mask and RoIs
    equal; its plain IoU on the card), the RoI-aware pool's cell of each
    voxel in each RoI (equal but for ``PARTA2_CELL_FLIPS``) and its pooled
    grids (within the gate at every cell that no flipped pair touches), the RoI head's convs and FC stacks on the card's pooled grids,
    on the proposals and on RoIs placed on the frame's gt boxes ``gt`` (1,
    M, 8) (``rcnn_cls`` / ``rcnn_reg`` within the gate), the refined boxes'
    post-processing (the detections paired box for box with the card's
    request).  The control: the card's first stage and RoI head with TF32
    on, on the same inputs, must exceed the gate.  Returns the card's first
    stage."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors.voxel_rcnn import post_processing
    from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT
    from pdanet_tpu_torch.ops.roi_pool import roi_point_cells

    b1 = requests[0]
    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
    gt_rois = gt[:, gt[0, :, 7] > 0, :7].contiguous()
    first_keys = ["seg_features", "point_cls_preds", "point_part_preds"]
    if "POINT_HEAD" in cfg.MODEL and cfg.MODEL.POINT_HEAD.TARGET_CONFIG.get("BOX_CODER"):
        first_keys.append("point_box_preds")

    def roi_inputs(first):
        return (first["point_coords"], first["seg_features"],
                torch.sigmoid(first["point_part_preds"]), first["point_cls_scores"],
                first["point_valid"])

    def second(head, inputs, rois_list, pooled=None):
        """The pooled grids of the RoI head's ``inputs`` (or ``pooled``, given)
        and its outputs on each of ``rois_list``."""
        pooled = pooled or [head.pool(*inputs, r) for r in rois_list]
        return pooled, [head.refine_pooled(*p, r.shape[1]) for p, r in zip(pooled, rois_list)]

    def gap(g, w):
        return ((g.cpu() - w).abs().max() / w.abs().max().clamp(min=1.0)).item()

    def gaps(got, want):
        out = {k: gap(got[0][k], want[0][k]) for k in first_keys}
        for what, (g, w) in zip(("proposals", "gt boxes"), zip(got[1], want[1])):
            out[f"rcnn_cls on the {what}"] = gap(g[0], w[0])
            out[f"rcnn_reg on the {what}"] = gap(g[1], w[1])
        return out

    with torch.inference_mode():
        with RecordIoUShapes() as rec_card:
            out_card = model.forward_batch(b1)
        first_card = model.first_stage(b1["voxels"], b1["voxel_coords"], b1["voxel_num_points"])
        rois = [out_card["rois"], gt_rois]
        inputs_card = roi_inputs(first_card)
        pooled_card, rcnn_card = second(model.roi_head, inputs_card, rois)
    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template, device="cpu")
    cpu_model.load_state_dict(weights)
    cpu_model.eval()
    cpu_b1 = {k: v.cpu() for k, v in b1.items()}
    t0 = time.perf_counter()
    with torch.inference_mode():
        first_cpu = cpu_model.first_stage(cpu_b1["voxels"], cpu_b1["voxel_coords"],
                                          cpu_b1["voxel_num_points"])
    cpu_s = time.perf_counter() - t0
    logit_err = 0.0
    if "cls_preds" in first_cpu:  # Part-A2's anchor head
        logit_err = (first_card["cls_preds"].cpu() - first_cpu["cls_preds"]).abs().max().item()
    require(logit_err <= 2e-3, f"{label} anchor logits card vs CPU {logit_err} > 2e-3")
    dev = b1["voxels"].device
    t0 = time.perf_counter()
    with torch.inference_mode():
        with plain_iou_on(dev), RecordIoUShapes() as rec_fed:
            props = RHT.proposal_layer(first_card["batch_cls_preds"].cpu(),
                                       first_card["batch_box_preds"].cpu(), nms_cfg)
        require(torch.equal(rec_fed.keeps[0], rec_card.keeps[0].cpu()),
                f"{label} proposal keep mask card vs CPU (the card's first stage fed)")
        for key in ("rois", "roi_labels", "roi_valid"):
            require(torch.equal(props[key], out_card[key].cpu()),
                    f"{label} proposals: {key} card vs CPU (the card's first stage fed)")
        inputs_cpu = [t.cpu() for t in inputs_card]
        g = (cpu_model.roi_head.grid,) * 3
        flips, in_box, untouched = [], [], []
        for r in rois:
            cells_card = roi_point_cells(r, inputs_card[0], g, inputs_card[4]).cpu()
            cells_cpu = roi_point_cells(r.cpu(), inputs_cpu[0], g, inputs_cpu[4])
            n_cells = r.shape[0] * r.shape[1] * int(np.prod(g))
            flipped = cells_card != cells_cpu
            flips.append(int(flipped.sum()))
            in_box.append(int((cells_cpu < n_cells).sum()))
            # the cells a flipped (RoI, voxel) pair leaves or enters differ by
            # right; every other cell is held to the gate
            keep = torch.ones(n_cells + 1, dtype=torch.bool)
            keep[torch.cat([cells_card[flipped], cells_cpu[flipped]])] = False
            untouched.append(keep[:n_cells])
        pooled_cpu, _ = second(cpu_model.roi_head, inputs_cpu, [r.cpu() for r in rois])
        cell_rows = lambda p: p.permute(0, 2, 3, 4, 1).reshape(-1, p.shape[1])  # noqa: E731
        pool_err = max(gap(cell_rows(pg)[keep.to(pg.device)], cell_rows(pc)[keep])
                       for p_c, p_g, keep in zip(pooled_cpu, pooled_card, untouched)
                       for pc, pg in zip(p_c, p_g))
        _, rcnn_cpu = second(cpu_model.roi_head, None, [r.cpu() for r in rois],
                             [tuple(t.cpu() for t in p) for p in pooled_card])
        errs = gaps((first_card, rcnn_card), (first_cpu, rcnn_cpu))
        occupied = [float((p[0] != 0).any(dim=1).float().mean()) for p in pooled_card]
        fed = {"batch_cls_preds": rcnn_cpu[0][0], "roi_labels": props["roi_labels"],
               "roi_valid": props["roi_valid"],
               "batch_box_preds": RHT.decode_roi_boxes(props["rois"], rcnn_cpu[0][1],
                                                       cpu_model.roi_box_coder)}
        post_cpu = post_processing(fed, cfg.MODEL)
    stage_s = time.perf_counter() - t0
    with torch.inference_mode(), tf32_on():
        first_tf32 = model.first_stage(b1["voxels"], b1["voxel_coords"], b1["voxel_num_points"])
        _, rcnn_tf32 = second(model.roi_head, None, rois, pooled_card)
    control_errs = gaps((first_tf32, rcnn_tf32), (first_cpu, rcnn_cpu))
    kept = rec_card.keeps[0].sum(dim=1).tolist()
    pairs, n_g, n_c, gap_c, gap_s = match_detections(results[0][2], post_cpu)
    print(f"{label} float32 frame, card vs CPU (the first stage {cpu_s:.1f} s, the rest "
          f"{stage_s:.1f} s on the CPU): anchor logits within {logit_err:.3g}; on the card's "
          f"inputs: the proposal layer's keep mask (candidates kept {kept} of "
          f"{rec_card.keeps[0].shape[1]}) and RoIs equal, {out_card['roi_valid'].sum().item()} "
          f"RoIs; the pool's cells of the voxels in the proposals and in frame 0's "
          f"{gt_rois.shape[1]} gt boxes: {flips} of {in_box} in-box (RoI, voxel) pairs in "
          f"another cell, pooled grids within {pool_err:.3g} of max(1, |value|) at the cells "
          f"no flipped pair touches, occupied "
          f"cells {occupied}; "
          f"detections {n_g} vs {n_c}, {pairs} paired (largest centre distance {gap_c:.3g} m, "
          f"score {gap_s:.3g})")
    for what, gaps_ in (("TF32 off", errs), ("TF32 on in cuDNN and cuBLAS, the control",
                                             control_errs)):
        over = sorted(k for k, v in gaps_.items() if not v <= PARTA2_STAGE_TOL)
        print(f"{label} stages card vs CPU, {what}: largest differences of max(1, |value|) "
              f"{ {k: float(f'{v:.3g}') for k, v in gaps_.items()} }; over PARTA2_STAGE_TOL "
              f"{PARTA2_STAGE_TOL}: {over}")
    require(max(flips) <= PARTA2_CELL_FLIPS, f"{label}: {flips} (RoI, voxel) pairs in another "
            f"cell card vs CPU, more than {PARTA2_CELL_FLIPS}")
    require(pool_err <= PARTA2_STAGE_TOL, f"{label} pooled grids card vs CPU at the cells no "
            f"flipped pair touches: {pool_err} of max(1, |value|)")
    require(min(occupied) > 0, f"{label}: a pool held no voxel {occupied}")
    bad = {k: v for k, v in errs.items() if not v <= PARTA2_STAGE_TOL}
    require(not bad, f"{label} first stage and RCNN outputs card vs CPU over "
            f"{PARTA2_STAGE_TOL} of max(1, |value|): {bad}")
    require(max(control_errs.values()) > PARTA2_STAGE_TOL, f"{label}: PARTA2_STAGE_TOL "
            f"{PARTA2_STAGE_TOL} passes the control's stages (TF32 on) too: {control_errs}")
    require(n_g == n_c == pairs and gap_c <= 1e-3 and gap_s <= 1e-4,
            f"{label} float32 detections card vs CPU not paired box for box")
    return first_card


def pointrcnn_card_vs_cpu(cfg, model, weights, template, requests, results, label):
    """Phase 19 (a): request 0's frame on the card against the CPU's plain
    path.  The first stage whole on each device: the backbone's FPS,
    ball-query and three-NN indices equal, its point features and the point
    head's logits, box codes and scores within ``PV_STAGE_TOL`` of max(1,
    |value|).  Then each stage on the card's own inputs, so that a float32
    difference upstream moves no index: the proposal layer on the card's
    first stage (keep mask and RoIs equal; its plain IoU on the card), the
    RoI point pool's (RoI, point) memberships (equal but for
    ``POINTRCNN_POOL_FLIPS``) and its canonical clouds (within the gate at
    every RoI that no flip touches), the RoI head on the card's pooled
    clouds (its SA stages' FPS and ball-query indices equal, ``rcnn_cls`` /
    ``rcnn_reg`` within the gate), the refined boxes' post-processing (the
    detections paired box for box with the card's request).  The control:
    the card's first stage and RoI head with TF32 on, on the same inputs,
    must exceed the gate.  Returns the card's first stage, request 0's FPS
    and ball queries as ``rcnn_picks`` (``RecordPicks``) beside it."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors.voxel_rcnn import post_processing
    from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT
    from pdanet_tpu_torch.ops import roi_pool

    b1 = requests[0]
    dev = b1["points"].device
    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
    head = model.roi_head
    with torch.inference_mode():
        with RecordPicks() as card:
            out_card = model.forward_batch(b1)
        first_card = model.first_stage(b1["points"])
        scores = first_card["point_cls_scores"]
        pooled_card = head.pool(first_card["point_coords"], first_card["point_features"], scores,
                                out_card["rois"])
    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template, device="cpu")
    cpu_model.load_state_dict(weights)
    cpu_model.eval()
    t0 = time.perf_counter()
    with torch.inference_mode(), RecordPicks() as cpu_first:
        first_cpu = cpu_model.first_stage(b1["points"].cpu())
    cpu_s = time.perf_counter() - t0
    n_fps, n_ball = len(cpu_first.fps), len(cpu_first.ball)
    for i, (c, g) in enumerate(zip(cpu_first.fps, card.fps)):
        require(torch.equal(c[2], g[2].cpu()), f"{label} backbone FPS {i} ({c[0].shape[1]} -> "
                f"{c[1]}) indices card vs CPU")
    for i, (c, g) in enumerate(zip(cpu_first.ball, card.ball)):
        for r, (ci, gi) in enumerate(zip(c[4], g[4])):
            require(torch.equal(ci, gi.cpu()), f"{label} backbone ball query {i} (radius "
                    f"{c[0][r]}) indices card vs CPU")
    for i, (c, g) in enumerate(zip(cpu_first.nn, card.nn)):
        require(torch.equal(c, g.cpu()), f"{label} FP module {i}: three-NN indices card vs CPU")

    def gap(g, w):
        return ((g.cpu() - w).abs().max() / w.abs().max().clamp(min=1.0)).item()

    stage_keys = ("point_features", "point_cls_preds", "point_box_preds", "point_cls_scores")
    errs = {k: gap(first_card[k], first_cpu[k]) for k in stage_keys}
    t0 = time.perf_counter()
    with torch.inference_mode():
        with plain_iou_on(dev):
            props = RHT.proposal_layer(first_card["batch_cls_preds"].cpu(),
                                       first_card["batch_box_preds"].cpu(), nms_cfg)
        for key in ("rois", "roi_labels", "roi_valid"):
            require(torch.equal(props[key], out_card[key].cpu()),
                    f"{label} proposals: {key} card vs CPU (the card's first stage fed)")
        # the pool's memberships on the same inputs, each device's own rotation
        coords, rois = first_card["point_coords"], out_card["rois"]
        extra = torch.tensor(head.extra_width, dtype=rois.dtype, device=dev)
        pool_rois = torch.cat([rois[..., 0:3], rois[..., 3:6] + extra, rois[..., 6:7]], dim=-1)
        inside = [roi_pool._in_box(*roi_pool._local_coords(c, r), r).cpu()
                  for c, r in ((coords, pool_rois), (coords.cpu(), pool_rois.cpu()))]
        flips = inside[0] != inside[1]
        touched = flips.any(dim=-1)  # (1, R)
        pooled_cpu = cpu_model.roi_head.pool(coords.cpu(), first_card["point_features"].cpu(),
                                             scores.cpu(), rois.cpu())
        errs["pooled clouds"] = gap(pooled_card[~touched], pooled_cpu[~touched])
        with RecordPicks() as cpu_head:
            rcnn_cls, rcnn_reg = cpu_model.roi_head.refine_pooled(pooled_card.cpu())
        for i, (c, g) in enumerate(zip(cpu_head.fps, card.fps[n_fps:])):
            require(torch.equal(c[2], g[2].cpu()), f"{label} RoI head FPS {i} ({c[0].shape[0]} "
                    f"clouds of {c[0].shape[1]} -> {c[1]}) indices card vs CPU")
        for i, (c, g) in enumerate(zip(cpu_head.ball, card.ball[n_ball:])):
            require(torch.equal(c[4][0], g[4][0].cpu()), f"{label} RoI head ball query {i} "
                    f"(radius {c[0][0]}) indices card vs CPU")
        errs["rcnn_cls"] = gap(out_card["rcnn_cls"], rcnn_cls)
        errs["rcnn_reg"] = gap(out_card["rcnn_reg"], rcnn_reg)
        fed = {"batch_cls_preds": rcnn_cls, "roi_labels": props["roi_labels"],
               "roi_valid": props["roi_valid"],
               "batch_box_preds": RHT.decode_roi_boxes(props["rois"], rcnn_reg,
                                                       cpu_model.roi_box_coder)}
        post_cpu = post_processing(fed, cfg.MODEL)
    stage_s = time.perf_counter() - t0
    want = {**{k: first_cpu[k] for k in stage_keys}, "pooled clouds": pooled_cpu[~touched],
            "rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg}
    # the control: the card's stages with TF32 on in cuDNN and cuBLAS, on
    # the inputs the CPU was given
    with torch.inference_mode(), tf32_on():
        control = model.first_stage(b1["points"])
        control["pooled clouds"] = head.pool(coords, control["point_features"],
                                             control["point_cls_scores"], rois)[~touched]
        control["rcnn_cls"], control["rcnn_reg"] = head.refine_pooled(pooled_card)
    control_errs = {k: gap(control[k], w) for k, w in want.items()}
    empty = int((pooled_card[..., 3:].abs().sum(dim=(-1, -2)) == 0).sum())
    counts = inside[0].sum(dim=-1)[0]
    pairs, n_g, n_c, gap_c, gap_s = match_detections(results[0][2], post_cpu)
    print(f"{label} float32 frame, card vs CPU (the first stage {cpu_s:.1f} s, the rest "
          f"{stage_s:.1f} s on the CPU): the backbone's {n_fps} FPS, {n_ball} ball-query and "
          f"{len(cpu_first.nn)} three-NN indices equal; on the card's inputs: the proposals "
          f"equal, {int(out_card['roi_valid'].sum())} RoIs; the pool's (RoI, point) "
          f"memberships {int(flips.sum())} flipped of {flips.numel()} (RoIs touched "
          f"{int(touched.sum())}), points in a RoI min / median / max {int(counts.min())} / "
          f"{int(counts.median())} / {int(counts.max())}, {empty} RoIs empty; the RoI head's "
          f"{len(cpu_head.fps)} FPS and {len(cpu_head.ball)} ball-query indices equal; "
          f"detections {n_g} vs {n_c}, {pairs} paired (largest centre distance {gap_c:.3g} m, "
          f"score {gap_s:.3g})")
    for what, gaps in (("TF32 off", errs),
                       ("TF32 on in cuDNN and cuBLAS, the control", control_errs)):
        print(f"{label} stages card vs CPU, {what}: largest differences of max(1, |value|) "
              f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} }; over PV_STAGE_TOL "
              f"{PV_STAGE_TOL}: {sorted(k for k, v in gaps.items() if not v <= PV_STAGE_TOL)}")
    require(int(flips.sum()) <= POINTRCNN_POOL_FLIPS, f"{label} pool: {int(flips.sum())} "
            f"(RoI, point) memberships card vs CPU, more than {POINTRCNN_POOL_FLIPS}")
    bad = {k: v for k, v in errs.items() if not v <= PV_STAGE_TOL}
    require(not bad, f"{label} stages card vs CPU over {PV_STAGE_TOL} of max(1, |value|): {bad}")
    require(max(control_errs.values()) > PV_STAGE_TOL, f"{label}: PV_STAGE_TOL {PV_STAGE_TOL} "
            f"passes the control's stages (TF32 on) too: {control_errs}")
    require(n_g == n_c == pairs and gap_c <= 1e-3 and gap_s <= 1e-4,
            f"{label} float32 detections card vs CPU not paired box for box")
    first_card.update(rcnn_picks=card, roi_points=head.num_sampled)
    return first_card


def pointrcnn_kernels(dev, first, label, suffix):
    """Phase 19 (e): the RoI head's first SA stage of request 0 (``first``'s
    ``rcnn_picks``) on its own inputs: FPS over the RoIs' canonical clouds
    (one launch of B * R frames of ``NUM_SAMPLED_POINTS`` points), and over
    the same clouds made degenerate (every third RoI empty: all its points at
    the origin; every other third cycling its first three points), equal to
    the plain version, which takes the lowest index among equal distances;
    its ball query equal; CUDA-event times in turns, device times under the
    profiler and bounds from these inputs.  Returns ``[(row name, kernel,
    the key of its launches in ``counted_launches``, numbers)]``."""
    import torch

    from pdanet_tpu_torch.models.roi_heads.pointrcnn_head import BALL_QUERY_SITE
    from pdanet_tpu_torch.ops import ball_query, sampling

    picks, N = first["rcnn_picks"], first["roi_points"]
    xyz, npoint, _ = next(f for f in picks.fps if f[0].shape[1] == N and f[0].shape[0] > 1)
    xyz = xyz.float().contiguous()
    B = xyz.shape[0]
    degenerate = xyz.clone()
    degenerate[0::3] = 0.0
    degenerate[1::3] = xyz[1::3, torch.arange(N, device=xyz.device) % 3]
    for what, cloud in (("request 0's RoI clouds", xyz),
                        ("the clouds with every third RoI empty and every other third cycling "
                         "three points", degenerate.contiguous())):
        got = sampling.farthest_point_sample_cuda(cloud, npoint)
        want = sampling.farthest_point_sample_plain(cloud, npoint)
        require(torch.equal(got, want), f"{label} FPS {B} x {N} -> {npoint} on {what}: "
                f"indices differ from the plain version")
        print(f"{'fps':27s} {label} {B} x {N}->{npoint} on {what}: indices equal")
    fps_ms, fps_plain = turns(lambda: sampling.farthest_point_sample_cuda(xyz, npoint),
                              lambda: sampling.farthest_point_sample_plain(xyz, npoint), 2)
    fps_dev = kernel_device_ms(lambda: sampling.farthest_point_sample_cuda(xyz, npoint),
                               "fps_kernel")
    # per step and point: 3 sub, 3 mul, 2 add, the min and the argmax compare
    bnd = bound(xyz.numel() * 4 + B * npoint * 4, B * npoint * N * 10, F32_OPS_PER_S)
    print(f"{'fps':27s} {label} {B} x {N}->{npoint}: kernel {fps_ms:.4f} ms (device "
          f"{fmt_ms(fps_dev)}, {1e3 * fps_ms / (npoint - 1):.4f} us per serial step, launch "
          f"shape {sampling.fps_config(N)}), plain {fps_plain:.4f} ms; bound {bnd[0]:.4f} ms "
          f"({bnd[1]}), kernel at {100 * bnd[0] / fps_ms:.1f} % of it")
    rows = [(f"fps_k{N}_roi{suffix}", "fps", f"fps_n{N}",
             dict(max_abs_err=0.0, ms=fps_ms, plain_ms=fps_plain, bound_ms=bnd[0],
                  bound_by=bnd[1], library_ms=None))]
    radii, ks, sup, ctr, _, _ = next(b for b in picks.ball
                                     if b[5] == BALL_QUERY_SITE and b[2].shape[1] == N)
    sup, ctr = sup.float().contiguous(), ctr.float().contiguous()
    got = ball_query.ball_query_multi_cuda(radii, ks, sup, ctr)
    want = ball_query.ball_query_multi_plain(radii, ks, sup, ctr)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{label} RoI head ball query differs from the plain version")
    scan, in_reach = ball_query_work(radii, ks, sup, ctr)
    bq_ms, bq_plain = turns(lambda: ball_query.ball_query_multi_cuda(radii, ks, sup, ctr),
                            lambda: ball_query.ball_query_multi_plain(radii, ks, sup, ctr), 2)
    bnd = bound((sup.numel() + ctr.numel() + sum(w.numel() for w in want)) * 4,
                in_reach * (8 + len(radii)), F32_OPS_PER_S)
    print(f"{'ball_query':27s} {label} RoI head: {B} clouds, N={N} M={ctr.shape[1]} radii "
          f"{radii} K {ks}, equal; kernel {bq_ms:.4f} ms, plain {bq_plain:.4f} ms; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}), kernel at {100 * bnd[0] / bq_ms:.1f} % of it")
    print_ball_query_work(f"{label} RoI head", radii, ks, sup, ctr, (scan, in_reach))
    rows.append((f"ball_query_{BALL_QUERY_SITE}{suffix}", "ball_query",
                 f"ball_query_{BALL_QUERY_SITE}",
                 dict(max_abs_err=0.0, ms=bq_ms, plain_ms=bq_plain, bound_ms=bnd[0],
                      bound_by=bnd[1], library_ms=None)))
    return rows


@contextlib.contextmanager
def tf32_on():
    """TF32 on in cuDNN and cuBLAS inside the block, off after it (as phase
    1 leaves it)."""
    import torch

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def _dense_backbone_type():
    from pdanet_tpu_torch.models.backbones_3d.voxel_backbone import _DenseBackbone8x

    return _DenseBackbone8x


def conv3d_operations(model, fn):
    """(operations, convolutions): twice the multiply-adds of every 3-D
    convolution that one call of ``fn`` runs through ``model``, counted
    from its output's shape, its input channels and its kernel."""
    import torch

    ops = []

    def hook(mod, inp, out):
        taps = mod.kernel_size[0] * mod.kernel_size[1] * mod.kernel_size[2]
        ops.append(2 * out.numel() * (mod.in_channels // mod.groups) * taps)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv3d)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return sum(ops), len(ops)


def dense_report(model, predict, b1, label, reps, layout=True):
    """Phase 15 (a): the dense 3-D ladder of a b1 request.  The request's
    latency with the grid in NCDHW against channels-last-3d (in turns:
    NCDHW, channels-last, channels-last, NCDHW); the ladder alone (scatter,
    occupancies, convolutions, masked BatchNorms) under CUDA events beside
    its 3-D convolutions' operations over the float32 peak (their bound),
    and its device split by full kernel name."""
    import torch

    bb = model.backbone_3d
    ms = {}
    try:
        for fmt in ("NCDHW", "channels-last-3d", "channels-last-3d", "NCDHW")[:4 if layout else 0]:
            bb.memory_format = (torch.channels_last_3d if fmt == "channels-last-3d"
                                else torch.contiguous_format)
            ms.setdefault(fmt, []).append(request_ms(predict, b1, reps=reps, warmup=1))
    finally:
        bb.memory_format = torch.contiguous_format
    if layout:
        print(f"{label} b1 request by the dense grid's layout: " + "; ".join(
            f"{fmt} latency " + " / ".join(f"{lat:.2f}" for lat, _ in turns) + " ms"
            for fmt, turns in ms.items()) + f" ({reps} after warm-up, two turns)")

    def ladder():
        with torch.inference_mode():
            return bb(model.vfe(b1["voxels"], b1["voxel_num_points"]), b1["voxel_coords"])

    ops, n_conv = conv3d_operations(model, ladder)
    ladder_ms = cuda_ms(ladder, reps=reps, warmup=1)
    bnd = ops / F32_OPS_PER_S * 1e3
    torch.cuda.reset_peak_memory_stats()
    ladder()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label} dense 3-D ladder of the b1 request (levels z {bb.z_chain}): {ladder_ms:.2f} "
          f"ms under CUDA events, peak {peak:.2f} GiB; its {n_conv} 3-D convolutions "
          f"{ops / 1e12:.3f} TFLOP, bound {bnd:.2f} ms at 67 TFLOP/s float32, the ladder at "
          f"{100 * bnd / ladder_ms:.1f} % of it")
    print_split(f"the {label} dense ladder, b1, under torch.profiler (full kernel names)",
                device_split(ladder, top=8, full=True))


def dense_card_vs_cpu(cfg, model, weights, template, requests, results, label, keeps, seed,
                      crop):
    """Phase 15 (a): the dense model's frame 0 on the card against the CPU.
    (1) On ``crop`` of POINT_CLOUD_RANGE (the voxel size and every other
    setting kept, the same weights, the frame through the crop's
    processors): the first stage's raw cls / box / direction maps within
    2e-3, the BEV map reported.  (2) At full width on the card's own
    inputs: SECOND-IoU's proposal layer on the CPU from the card's first
    stage (keep mask, RoIs, scores and labels equal), the BEV pool and the
    IoU head on the CPU from the card's BEV map (``rcnn_iou`` within 2e-3),
    its post-processing; the multi-head's multi-class NMS on the CPU from
    the card's scores and boxes, fed the plain IoU of the card's candidates
    (computed on the card), each class's keep mask equal to the kernel's; the
    detections paired box for box with the card's request.  Returns the
    card's first-stage forward of frame 0."""
    import torch

    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors import get_post_processor
    from pdanet_tpu_torch.models.detectors.second import SECOND
    from pdanet_tpu_torch.models.model_utils.model_nms_utils import batched_multi_classes_nms
    from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT
    from pdanet_tpu_torch.ops.rotated_iou import boxes_iou_bev_batched_self_plain

    names = list(cfg.CLASS_NAMES)
    dev = requests[0]["voxels"].device
    cpu = torch.device("cpu")
    # (1) the crop
    crop_cfg = copy.deepcopy(cfg)
    crop_cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(crop)
    crop_template = DatasetTemplate(dataset_cfg=crop_cfg.DATA_CONFIG, class_names=names,
                                    training=False, root_path=template.root_path)
    crop_models = {}
    for device in (dev, cpu):
        m = build_network(crop_cfg.MODEL, len(names), dataset=crop_template, device=device)
        m.load_state_dict(weights)
        crop_models[device.type] = m.eval()
    batch, _ = voxel_batch(crop_cfg, voxel_frames(seed, 1, names), False, dev,
                           crop_models["cuda"])
    batch.pop("gt_boxes", None)
    args = [batch[k] for k in ("voxels", "voxel_coords", "voxel_num_points")]
    with torch.inference_mode():
        first = {d: SECOND.forward(crop_models[d], *[a.to(d) for a in args])
                 for d in ("cuda", "cpu")}
    errs = {}
    for key in ("cls_preds", "box_preds", "dir_cls_preds", "spatial_features"):
        want = first["cpu"][key]
        errs[key] = (first["cuda"][key].cpu() - want).abs().max().item()
    rel_bev = errs["spatial_features"] / max(first["cpu"]["spatial_features"].abs().max().item(),
                                             1e-30)
    print(f"{label} crop {list(crop)} (grid {crop_template.grid_size.tolist()}, "
          f"{int((batch['voxel_num_points'] > 0).sum())} voxels of frame 0), card vs CPU: "
          f"first-stage maps within {errs['cls_preds']:.3g} (cls) / {errs['box_preds']:.3g} "
          f"(box) / {errs['dir_cls_preds']:.3g} (direction); BEV map within "
          f"{errs['spatial_features']:.3g} ({rel_bev:.3g} of its largest)")
    require(max(errs["cls_preds"], errs["box_preds"], errs["dir_cls_preds"]) <= 2e-3,
            f"{label} first-stage maps on the crop card vs CPU {errs} > 2e-3")
    del crop_models, first

    # (2) full width, the card's inputs
    b1 = requests[0]
    cpu_model = build_network(cfg.MODEL, len(names), dataset=template, device="cpu")
    cpu_model.load_state_dict(weights)
    cpu_model.eval()
    with torch.inference_mode():
        first = SECOND.forward(model, b1["voxels"], b1["voxel_coords"], b1["voxel_num_points"])
        if "ROI_HEAD" in cfg.MODEL:
            out_card = model.forward_batch(b1)
            nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST
            with RecordIoUShapes() as rec_cpu:
                props = RHT.proposal_layer(first["batch_cls_preds"].cpu(),
                                           first["batch_box_preds"].cpu(), nms_cfg)
            K = rec_cpu.shapes[0][1]
            card_keep = next(k for k in keeps if k.shape[1] == K)[:1].cpu()
            require(torch.equal(rec_cpu.keeps[0], card_keep),
                    f"{label} proposal keep mask at K {K} card vs CPU (the card's first stage fed)")
            for key in ("rois", "roi_scores", "roi_labels", "roi_valid"):
                require(torch.equal(props[key], out_card[key].cpu()),
                        f"{label} proposals: {key} card vs CPU (the card's first stage fed)")
            pool = cfg.MODEL.ROI_HEAD.ROI_GRID_POOL
            pooled = RHT.roi_grid_pool_bev(out_card["spatial_features_2d"].cpu(), props["rois"],
                                           int(pool.GRID_SIZE), cpu_model.point_cloud_range,
                                           cpu_model.voxel_size, int(pool.DOWNSAMPLE_RATIO))
            rcnn_iou = cpu_model.roi_head(pooled)
            iou_err = (rcnn_iou - out_card["rcnn_iou"].cpu()).abs().max().item()
            require(iou_err <= 2e-3, f"{label} rcnn_iou card vs CPU {iou_err} > 2e-3")
            fed = {"rcnn_iou": rcnn_iou, "batch_box_preds": props["rois"], **{
                k: props[k] for k in ("roi_scores", "roi_labels", "roi_valid")}}
            post_cpu = get_post_processor(cfg.MODEL.NAME)(fed, cfg.MODEL)
            note = (f"the proposal keep mask at K {K} ({int(card_keep.sum())} kept) and the "
                    f"{int(props['roi_valid'].sum())} RoIs equal; rcnn_iou within {iou_err:.3g}")
            first["final_forward"] = out_card
        else:
            with RecordIoUShapes(keep_boxes=True) as rec_card:
                get_post_processor(cfg.MODEL.NAME)(first, cfg.MODEL)
            fed = [boxes_iou_bev_batched_self_plain(b).cpu() for b in rec_card.boxes]
            # the card's scores: a float32 sigmoid of the CPU and of CUDA may
            # round an ulp apart, which reorders scores that near-tie
            post_cfg = cfg.MODEL.POST_PROCESSING
            scores = torch.sigmoid(first["batch_cls_preds"]).cpu()
            with RecordIoUShapes(feed=fed) as rec_cpu:
                post_cpu = batched_multi_classes_nms(
                    scores, first["batch_box_preds"].cpu(),
                    torch.ones(scores.shape[:2], dtype=torch.bool), post_cfg.NMS_CONFIG,
                    score_thresh=float(post_cfg.SCORE_THRESH))
            require(len(rec_cpu.keeps) == len(rec_card.keeps) == len(names) and all(
                torch.equal(c, g.cpu()) for c, g in zip(rec_cpu.keeps, rec_card.keeps)),
                f"{label}: a class's keep mask card vs CPU (the plain IoU of the card's "
                f"candidates fed)")
            note = (f"{len(names)} per-class keep masks at K {rec_card.shapes[0][1]} equal "
                    f"({[int(k.sum()) for k in rec_cpu.keeps]} kept)")
    pairs, n_g, n_c, gap_c, gap_s = match_detections(results[0][2], post_cpu)
    print(f"{label} b1 frame at full width, card vs CPU on the card's inputs: {note}; "
          f"detections {n_g} vs {n_c}, {pairs} paired (largest centre distance {gap_c:.3g} m, "
          f"score {gap_s:.3g})")
    require(n_g == n_c == pairs and gap_c <= 1e-3 and gap_s <= 1e-4,
            f"{label} float32 detections card vs CPU not paired box for box")
    # the dense levels (~8 GB a forward) would stay allocated through (b)
    for out in (first, first.get("final_forward", {})):
        out.pop("multi_scale_3d_features", None)
    return first


def seed_center_boxes(model, classes):
    """Scale a seeded CenterPoint head's box outputs by
    ``CENTER_CONV_SCALE`` (the dim, centre and heading-sine output convs of
    every head), the dim bias the log of ``classes[0]``'s mean size."""
    import torch

    size = torch.log(torch.tensor(KITTI_MEAN_SIZES[classes[0]], dtype=torch.float32))
    dense_head = model.dense_head
    with torch.no_grad():
        for i in range(dense_head.num_heads):
            head = getattr(dense_head, f"head_{i}")
            for conv in (head.dim_out, head.center_out):
                conv.weight.mul_(CENTER_CONV_SCALE)
                conv.bias.mul_(CENTER_CONV_SCALE)
            head.dim_out.bias.add_(size.to(head.dim_out.bias))
            head.rot_out.weight[1].mul_(CENTER_CONV_SCALE)  # (cos, sin): heading 0 or pi
            head.rot_out.bias[1].mul_(CENTER_CONV_SCALE)


def voxel_serve(cfg, dev, template, label, seed, depth):
    """Phases 12-16 (a): seeded weights at full width (a two-stage model's
    box conv scaled by ``BOX_CONV_SCALE``, CenterPoint's head by
    ``seed_center_boxes``); 120000-point LiDAR-like KITTI
    frames through the host voxelizer at the test budget; three b1
    requests and one b2 in float32 through ``serving.make_predict_fn``,
    their latency, the IoU and NMS kernels launched at every K of
    ``serve_ks``; a b1 request's latency, host enqueue and device split,
    beside one with TF32 on in cuDNN and cuBLAS (this script turns it off
    in phase 1), and each request's peak memory; a dense 3-D backbone's
    b1 latency in NCDHW against channels-last-3d and its convolutions'
    operations (``dense_report``); a two-stage model's RoI traffic
    (``roi_traffic``); one frame on the card against the CPU
    (``pv_card_vs_cpu``, ``vrcnn_card_vs_cpu``, ``dense_card_vs_cpu`` or
    ``anchors_card_vs_cpu``).  ``depth``: ``latency_reps``,
    ``serve_requests`` 1 for one b1 request alone, ``tf32`` False for no
    TF32 turns, ``layout`` False for no layout turns.  Returns the launches of
    the requests, the weights, the closure, frame 0's batch and
    (first-stage) forward and the requests' ``RecordIoUShapes`` (with the
    IoU's input boxes)."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.serving import (example_device_batch, make_predict_fn,
                                          serving_input_spec)

    two_stage = "ROI_HEAD" in cfg.MODEL
    model = init_random_weights(build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template,
                                              device=dev), seed=0)
    if two_stage:
        with torch.no_grad():
            if hasattr(model, "dense_head"):
                model.dense_head.conv_box.weight.mul_(BOX_CONV_SCALE)
            else:  # Part-A2-free: the point head's boxes are the proposals
                model.point_head.box_out.weight.mul_(BOX_CONV_SCALE)
                model.point_head.box_out.bias.mul_(BOX_CONV_SCALE)
    elif cfg.MODEL.DENSE_HEAD.NAME == "CenterHead":
        seed_center_boxes(model, cfg.CLASS_NAMES)
    weights = copy.deepcopy(model.state_dict())
    predict = make_predict_fn(model, cfg.MODEL)
    for B in (1, 2):
        predict(example_device_batch(cfg, serving_input_spec(cfg, B, model), dev))
    latency_reps = depth.get("latency_reps", VOXEL_LATENCY_REPS)
    dense = isinstance(getattr(model, "backbone_3d", None), _dense_backbone_type())
    frames = voxel_frames(seed, VOXEL_SERVE_FRAMES, cfg.CLASS_NAMES)
    requests, gts, host_ms = [], [], []
    chunks = ([frames[0]], frames[3:5], [frames[1]], [frames[2]])  # b1, b2, b1, b1
    for chunk in chunks[:depth.get("serve_requests", len(chunks))]:
        batch, ms = voxel_batch(cfg, chunk, False, dev, model)
        gts.append(batch.pop("gt_boxes"))  # a request carries the voxels alone
        requests.append(batch)
        host_ms += ms
    ks = serve_ks(cfg)
    max_dets = min(int(post_cfg_of(cfg).NMS_CONFIG.NMS_POST_MAXSIZE), min(ks))
    if post_cfg_of(cfg).NMS_CONFIG.get("MULTI_CLASSES_NMS", False):
        max_dets *= len(cfg.CLASS_NAMES)  # one segment of slots a class
    print(f"{label} frames: {KITTI_FRAME_POINTS} points each, host processors (test split) "
          f"{[round(t, 1) for t in host_ms]} ms a frame; the requests "
          f"{[describe_batch(r) for r in requests]}")
    torch.cuda.synchronize()

    clear_launches()
    results, peaks = [], []
    with RecordIoUShapes(keep_boxes=True) as rec:
        for batch in requests:
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            res = predict(batch)
            torch.cuda.synchronize()
            results.append((batch_frames(batch), (time.perf_counter() - t0) * 1e3, res))
            peaks.append(round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2))
    launches = counted_launches()
    for i, (B, ms, res) in enumerate(results):
        for key, val in res.items():
            require(tuple(val.shape[:1]) == (B,), f"{label} request {i}: {key} batch shape")
            require(bool(torch.isfinite(val.float()).all()),
                    f"{label} request {i}: {key} not finite")
        counts = res["pred_counts"]
        require(bool(((counts >= 0) & (counts <= max_dets)).all()),
                f"{label} request {i}: counts {counts}")
        print(f"{label} request {i}: B={B} latency {ms:.2f} ms (float32, TF32 off), "
              f"detections {counts.tolist()}")
    print(f"{label} kernel launches in the served requests: {launches}; the self-IoU's "
          f"inputs {rec.shapes}, candidates kept by the walks "
          f"{[k.sum(dim=1).tolist() for k in rec.keeps]} of the valid "
          f"{[v.sum(dim=1).tolist() for v, _ in rec.walks]}; peak memory a request {peaks} GiB")
    kernels = path_kernels(model)
    for name in kernels:
        require(launches.get(name, 0) > 0, f"kernel {name} never launched on the {label} "
                f"path")
    require({s[1] for s in rec.shapes} == ks,
            f"the {label} self-IoU ran at {rec.shapes}, not K {sorted(ks)}")
    b1 = requests[0]
    # latency with TF32 off, then on, before any profiler runs
    ms = {False: [], True: []}

    def set_tf32(on):
        torch.backends.cudnn.allow_tf32 = on
        torch.backends.cuda.matmul.allow_tf32 = on

    tf32_turns = depth.get("tf32", True)
    try:
        for tf32 in (False, True) if tf32_turns else (False,):
            set_tf32(tf32)
            ms[tf32].append(request_ms(predict, b1, reps=latency_reps))
        set_tf32(True)
        split_tf32 = device_split(lambda: predict(b1)) if tf32_turns else None
    finally:
        set_tf32(False)  # as phase 1 left it
    print_split(f"a {label} b1 request under torch.profiler (TF32 off)",
                device_split(lambda: predict(b1)))
    if tf32_turns:
        print_split(f"a {label} b1 request under torch.profiler (TF32 on in cuDNN and cuBLAS)",
                    split_tf32)
    for tf32, reads in ((k, v) for k, v in ms.items() if v):
        print(f"{label} b1 request with TF32 {'on' if tf32 else 'off'}: median "
              f"latency " + " / ".join(f"{lat:.2f}" for lat, _ in reads) + " ms, host enqueue "
              + " / ".join(f"{enq:.2f}" for _, enq in reads) + f" ms ({latency_reps} after "
              f"warm-up, {len(reads)} turn(s))")
    if dense:
        dense_report(model, predict, b1, label, latency_reps, depth.get("layout", True))
    if not depth.get("compare", True):
        out = {}
    elif is_pointrcnn_model(model):
        out = pointrcnn_card_vs_cpu(cfg, model, weights, template, requests, results, label)
    elif cfg.MODEL.NAME in PV_NAMES:
        out = pv_card_vs_cpu(cfg, model, weights, template, requests, results, label, gts[0])
    elif is_parta2(cfg):
        out = parta2_card_vs_cpu(cfg, model, weights, template, requests, results, label,
                                 gts[0])
    elif two_stage and hasattr(model.roi_head, "pool"):
        roi_traffic(cfg, model, requests, rec.keeps, label)
        out = vrcnn_card_vs_cpu(cfg, model, weights, template, requests, results, label,
                                gts[0])
    elif dense:
        out = dense_card_vs_cpu(cfg, model, weights, template, requests, results, label,
                                rec.keeps, seed, depth["crop"])
    elif cfg.MODEL.NAME == "CenterPoint":
        out = center_card_vs_cpu(cfg, model, weights, template, requests, results, label)
    else:
        out = anchors_card_vs_cpu(cfg, model, weights, template, requests, results, label)
    return launches, weights, predict, b1, out, rec, kernels


def plant_gt(cfg, model, batch, n):
    """``batch`` with ``n`` more gt boxes a frame, on the first ``n``
    proposals the TRAIN proposal layer keeps in a training-mode forward
    of ``model`` (a throwaway copy: its BatchNorm statistics move), so
    that a seeded two-stage model samples foreground RoIs."""
    import torch

    from pdanet_tpu_torch.models.detectors.second import SECOND
    from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT

    # SECOND's forward, or a Part-A2 or PointRCNN model's first stage
    # (Part-A2-free's and PointRCNN's proposals are their point head's boxes)
    model.train()
    first_stage = getattr(model, "first_stage", lambda *a: SECOND.forward(model, *a))
    inputs = ((batch["points"],) if "voxels" not in batch else
              (batch["voxels"], batch["voxel_coords"], batch["voxel_num_points"]))
    with torch.no_grad():
        first = first_stage(*inputs)
        props = RHT.proposal_layer(first["batch_cls_preds"], first["batch_box_preds"],
                                   cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN)
    gt = batch["gt_boxes"]
    extra = []
    for b in range(gt.shape[0]):
        pick = torch.nonzero(props["roi_valid"][b])[:n, 0]
        require(len(pick) == n, f"plant_gt: {len(pick)} proposals kept, want {n}")
        extra.append(torch.cat([props["rois"][b, pick],
                                props["roi_labels"][b, pick, None].to(gt.dtype)], -1))
    return {**batch, "gt_boxes": torch.cat([gt, torch.stack(extra).to(gt.dtype)], dim=1)}


class RecordSamples:
    """Counts, in each RoI sample a two-stage training forward draws
    (``roi_head_template.assign_targets``), the sampled RoIs that are
    foreground (``reg_valid_mask``: IoU above REG_FG_THRESH), keeps each
    sample's IoUs and classification labels (``targets``) and the RoIs'
    3-D IoUs with the gt that the sampler computes (``ious``); with
    ``feed`` it returns those in turn instead (their float32 BEV overlap
    rounds in the last place apart on the card and the CPU, and the
    roi_iou soft labels carry it into the loss)."""

    def __init__(self, feed=None):
        self.feed = None if feed is None else list(feed)

    def __enter__(self):
        from pdanet_tpu_torch.models.roi_heads import roi_head_template as RHT

        self.module, self.fg, self.ious, self.targets = RHT, [], [], []
        self.orig = (RHT.assign_targets, RHT.boxes_iou3d)

        def assign(*args, **kwargs):
            t = self.orig[0](*args, **kwargs)
            self.fg.append(int((t["reg_valid_mask"] > 0).sum()))
            self.targets.append({k: t[k].detach() for k in ("gt_iou_of_rois",
                                                            "rcnn_cls_labels")})
            return t

        def iou3d(a, b):
            if self.feed is not None:
                return self.feed.pop(0).to(a.device)
            out = self.orig[1](a, b)
            self.ious.append(out)
            return out

        RHT.assign_targets, RHT.boxes_iou3d = assign, iou3d
        return self

    def __exit__(self, *exc):
        self.module.assign_targets, self.module.boxes_iou3d = self.orig


class RecordPicks:
    """Records the indices that PV-RCNN's VSA and RoI head and PointRCNN's
    backbone and RoI head pick (their modules' ``farthest_point_sample``,
    ``ball_query_multi`` and ``ball_query``, the kernels running as ever;
    ``three_nn`` of ``vector_pool``, PV-RCNN++'s, and of the PointNet++
    FP modules), with the inputs of the first two, in call order.  With
    ``feed`` (another run's :meth:`picks`, or some of its kinds) it returns
    those indices in turn instead: the CPU's runs take the card's picks, as
    phase 7's ``fed`` does for PDA-SSD (a fed ``three_nn`` keeps its
    distances' arithmetic on this run's inputs)."""

    def __init__(self, feed=None):
        self.feed = {k: list(v) for k, v in (feed or {}).items()}

    def __enter__(self):
        from pdanet_tpu_torch.models.backbones_3d import pointnet2_backbone as pn2
        from pdanet_tpu_torch.models.backbones_3d.pfe import vector_pool as vp
        from pdanet_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction as vsa
        from pdanet_tpu_torch.models.roi_heads import pointrcnn_head as prh
        from pdanet_tpu_torch.ops.interpolate import picked_dist2

        self.fps, self.ball, self.nn, self.patched = [], [], [], []

        def fps(orig):
            def run(xyz, npoint):
                if "fps" in self.feed:
                    return self.feed["fps"].pop(0).to(xyz.device)
                idx = orig(xyz, npoint)
                self.fps.append((xyz, npoint, idx))
                return idx
            return run

        def ball(orig):
            def run(radii, nsamples, xyz, new_xyz, site=""):
                if "ball" in self.feed:
                    return tuple(t.to(xyz.device) for t in self.feed["ball"].pop(0))
                out = orig(radii, nsamples, xyz, new_xyz, site)
                self.ball.append((tuple(radii), tuple(nsamples), xyz, new_xyz, out, site))
                return out
            return run

        def ball_one(orig):  # the single-radius form, recorded as one radius of many
            multi = ball(lambda radii, ks, xyz, new_xyz, site="": (
                orig(radii[0], ks[0], xyz, new_xyz, site),))
            return lambda radius, nsample, xyz, new_xyz, site="": multi(
                (radius,), (nsample,), xyz, new_xyz, site)[0]

        def nn(orig):
            def run(unknown, known):
                if "nn" in self.feed:
                    idx = self.feed["nn"].pop(0).to(unknown.device)
                    return picked_dist2(unknown, known, idx), idx
                d2, idx = orig(unknown, known)
                self.nn.append(idx)
                return d2, idx
            return run

        for module, name, wrap in ((vsa, "farthest_point_sample", fps),
                                   (vsa, "ball_query_multi", ball), (vp, "three_nn", nn),
                                   (pn2, "farthest_point_sample", fps),
                                   (pn2, "ball_query_multi", ball), (pn2, "three_nn", nn),
                                   (prh, "farthest_point_sample", fps),
                                   (prh, "ball_query", ball_one)):
            self.patched.append((module, name, getattr(module, name)))
            setattr(module, name, wrap(getattr(module, name)))
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self.patched):
            setattr(module, name, orig)

    def picks(self):
        """The recorded indices on the CPU, another run's ``feed``."""
        return {"fps": [idx.cpu() for *_, idx in self.fps],
                "ball": [tuple(t.cpu() for t in b[4]) for b in self.ball],
                "nn": [idx.cpu() for idx in self.nn]}


def voxel_train(cfg, weights, dev, template, label, seed, train_steps=VOXEL_TRAIN_STEPS,
                batch_size=None, crop=None, split=True, float64=True):
    """Phases 12-15 (b): ``train_steps`` float32 steps at the yaml's batch
    size (or ``batch_size``) on the train budget (frames through the train split's processors,
    gt on their boxes; for a two-stage model ``PLANTED_GT`` more a frame on
    its proposals, so that foreground RoIs are sampled): finite losses and
    gradients, the IoU and NMS kernels launched at the TRAIN proposal
    layer's K and suppressing there (a two-stage model) or not at all,
    foreground in the first step's sample, the step time, peak memory and
    a device split; then one float64 step at B = 1 on the card against the
    CPU, each frame's draws from the same CPU generator on both (a
    two-stage model: gt planted again, the CPU's proposal layer fed the
    plain IoU of the card's candidates, computed on the card, and its keep
    mask equal to the card kernel's, the CPU's sampler fed the card's 3-D
    IoUs of the RoIs with the gt; PointRCNN's and PV-RCNN's FPS,
    ball-query and three-NN picks the card's), on ``crop`` of
    POINT_CLOUD_RANGE where given (a dense 3-D backbone: the CPU's float64
    step at full width would take many minutes); not with ``float64``
    False.  With ``CLS_SCORE_TYPE`` roi_iou every sample's classification
    labels are the soft labels of its IoUs.  Returns the steps' launches."""
    import torch

    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.ops.rotated_iou import boxes_iou_bev_batched_self_plain
    from pdanet_tpu_torch.train import build_optimizer_and_schedule, make_train_step

    two_stage = "ROI_HEAD" in cfg.MODEL
    B = batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    frames = voxel_frames(seed, B, cfg.CLASS_NAMES)
    np.random.seed(seed)  # shuffle_points
    ocfg = cfg.OPTIMIZATION
    K_train = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE) if two_stage else None

    def fresh(device, dtype, geometry=(cfg, template)):
        model = build_network(geometry[0].MODEL, len(cfg.CLASS_NAMES), dataset=geometry[1],
                              device=device)
        model.load_state_dict(weights)
        return model.to(dtype)

    def train_model(device, dtype=torch.float32, geometry=(cfg, template)):
        model = fresh(device, dtype, geometry)
        optimizer, schedule = build_optimizer_and_schedule(
            model, ocfg, total_iters_each_epoch=3712 // B, total_epochs=ocfg.NUM_EPOCHS)
        return model, make_train_step(model, optimizer, schedule)

    model, step = train_model(dev)
    batch, host_ms = voxel_batch(cfg, frames, True, dev, model)
    plain_batch = batch
    if two_stage:
        batch = plant_gt(cfg, fresh(dev, torch.float32), batch, PLANTED_GT)
    print(f"{label} train frames: host processors (train split) "
          f"{[round(t, 1) for t in host_ms]} ms a frame; {describe_batch(batch)}, gt boxes "
          f"{(batch['gt_boxes'][..., 7] > 0).sum(dim=1).tolist()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    clear_launches()
    times, losses = [], []
    with RecordIoUShapes() as rec, RecordSamples() as samples:
        for i in range(train_steps):
            t0 = time.perf_counter()
            loss, tb = step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            require(np.isfinite(losses[-1]), f"{label} step {i}: loss {losses[-1]}")
            require(_grads_finite(model), f"{label} step {i}: gradients not finite")
    fg = samples.fg
    launches = counted_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if two_stage:
        require(rec.shapes and all(s == (B, K_train, 7) for s in rec.shapes),
                f"the {label} training self-IoU ran at {rec.shapes}, not B {B} K {K_train}")
        for name in path_kernels(model):
            require(launches.get(name, 0) > 0, f"kernel {name} never launched in {label} "
                    f"training")
        kept = [k.sum(dim=1).tolist() for k in rec.keeps]
        require(any(n < K_train for frame in kept for n in frame),
                f"{label} training: the proposal layer's walk suppressed no candidate {kept}")
        require(fg[0] > 0, f"{label} step 0: no foreground RoI sampled")
        print(f"{label} training: candidates kept by the walk at K {K_train} a step {kept}; "
              f"foreground RoIs (IoU above REG_FG_THRESH) in each step's sample {fg}")
        target = cfg.MODEL.ROI_HEAD.TARGET_CONFIG
        if target.CLS_SCORE_TYPE == "roi_iou":  # the soft labels of the sampled RoIs' IoUs
            lo, hi = float(target.CLS_BG_THRESH), float(target.CLS_FG_THRESH)
            soft = 0
            for t in samples.targets:
                iou, labels = t["gt_iou_of_rois"], t["rcnn_cls_labels"]
                want = torch.where(iou > hi, 1.0, torch.where(iou < lo, 0.0, (iou - lo) / (hi - lo)))
                require(torch.equal(labels, want.to(labels.dtype)),
                        f"{label}: the roi_iou labels are not the soft labels of the IoUs")
                soft += int(((labels > 0) & (labels < 1)).sum())
            print(f"{label} training: CLS_SCORE_TYPE roi_iou, every sampled RoI's label the "
                  f"soft label of its IoU (between CLS_BG_THRESH {lo} and CLS_FG_THRESH {hi}); "
                  f"{soft} labels strictly between 0 and 1, "
                  f"{sum(int((t['rcnn_cls_labels'] == 1).sum()) for t in samples.targets)} at 1")
    else:
        require(not rec.shapes, f"{label} training ran a self-IoU: {rec.shapes}")
    if split:
        print_split(f"a {label} float32 train step B={B} under torch.profiler (TF32 off)",
                    device_split(lambda: step(batch)))
    print(f"{label} train float32 B={B}: losses {[round(x, 4) for x in losses]}; ms/step "
          f"{[round(t, 2) for t in times]}, median after warm-up "
          f"{statistics.median(times[1:] or times):.2f} ms; peak memory {peak:.2f} GiB; launches "
          f"{launches}; tb of the last step "
          f"{ {k: round(float(v), 4) for k, v in tb.items()} }")
    del model, step
    if not float64:
        return launches

    # one float64 step at B = 1, the card against the CPU from the same weights
    geometry, where = (cfg, template), ""
    if crop is not None:
        crop_cfg = copy.deepcopy(cfg)
        crop_cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(crop)
        geometry = (crop_cfg, DatasetTemplate(dataset_cfg=crop_cfg.DATA_CONFIG,
                                              class_names=cfg.CLASS_NAMES, training=False,
                                              root_path=template.root_path))
        np.random.seed(seed)
        plain_batch, _ = voxel_batch(crop_cfg, frames[:1], True, dev)
        where = f" on the crop {list(crop)} (grid {geometry[1].grid_size.tolist()})"
    torch.cuda.empty_cache()
    one = {k: (v[:1].double() if v.is_floating_point() else v[:1])
           for k, v in plain_batch.items()}
    if two_stage:
        one = plant_gt(geometry[0], fresh(dev, torch.float64, geometry), one, PLANTED_GT)
    res, fed, fed_3d, picks = [], None, None, None
    for device in (dev, torch.device("cpu")):
        model, step = train_model(device, torch.float64, geometry)
        t0 = time.perf_counter()
        with RecordIoUShapes(keep_boxes=fed is None, feed=fed) as rec, \
                RecordSamples(feed=fed_3d) as samples, RecordPicks(feed=picks) as pv:
            loss, tb = step({k: v.to(device) for k, v in one.items()})
        if fed is None:
            fed = [boxes_iou_bev_batched_self_plain(b).cpu() for b in rec.boxes]
            fed_3d = [t.cpu() for t in samples.ious]
            picks = pv.picks()
        res.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                    {n: b.cpu() for n, b in model.named_buffers() if "running" in n},
                    time.perf_counter() - t0, sum(samples.fg), [k.cpu() for k in rec.keeps]))
        del model, step
    (l_g, g_g, s_g, t_g, r_g, k_g), (l_c, g_c, s_c, t_c, r_c, k_c) = res
    rel = abs(l_g - l_c) / abs(l_c)
    errs = _leaf_errors(g_g, g_c, floor=1e-6)
    stat_err = max((s_g[n] - s_c[n]).abs().max().item() for n in s_c)
    keeps_equal = len(k_g) == len(k_c) and all(map(torch.equal, k_g, k_c))
    pv_note = (f", the card's {len(picks['fps'])} FPS picks, {len(picks['ball'])} ball "
               f"queries and {len(picks['nn'])} three-NN searches" if picks["fps"] else "")
    fed_note = (f", the CPU fed the plain IoU of the card's K {fed[0].shape[1]} candidates"
                f"{pv_note} and "
                f"the card's 3-D IoUs of the RoIs with the gt; proposal "
                f"keep mask {'equal' if keeps_equal else 'different'}, foreground RoIs "
                f"sampled {r_g} / {r_c}" if two_stage else "")
    print(f"{label} float64 step B=1{where}, card vs CPU ({t_g:.1f} s / {t_c:.1f} s{fed_note}): loss "
          f"{l_g:.17g} vs {l_c:.17g} (rel {rel:.3g}); gradient leaves within "
          f"{errs[0][0]:.3g} of their scale at worst ({errs[0][1]}), deciles "
          f"{_deciles(errs)}; statistics within {stat_err:.3g}")
    require(keeps_equal, f"{label} float64 step: proposal keep mask card vs CPU")
    require(rel <= 1e-10, f"{label} float64 loss card vs CPU rel {rel}")
    require(errs[0][0] <= 1e-8, f"{label} float64 gradients card vs CPU: {errs[:3]}")
    require(stat_err <= 1e-10, f"{label} float64 statistics card vs CPU {stat_err}")
    require(not two_stage or r_c > 0, f"{label} float64 step: no foreground RoI sampled")
    return launches


def voxel_clis(work, kitti_run, cfg_rel, label, batch_size, export=False,
               kernels=VOXEL_KERNELS):
    """Phases 12-16 (c): the yaml through the train CLI (one epoch of the
    root's train frames at ``batch_size``, augmentor and all) and the test
    CLI on its checkpoint with the official KITTI evaluation (each of
    ``kernels`` launched there); with ``export`` also the export CLI on the checkpoint at b1 with its
    ``--verify`` (the saved program against the live model).  Returns the
    launches of the train, test and export CLIs."""
    from pdanet_tpu_torch.tools import test as test_cli
    from pdanet_tpu_torch.tools import train as train_cli

    root, val_ids = kitti_run["root"], kitti_run["val_ids"]
    set_data = ["--set", "DATA_CONFIG.DATA_PATH", str(root), *kitti_run.get("set", ())]
    with contextlib.chdir(work):
        clear_launches()
        t0 = time.perf_counter()
        out = train_cli.main(["--cfg_file", cfg_rel, "--epochs", "1", "--batch_size",
                              str(batch_size), "--num_epochs_to_eval", "0", *set_data])
        train_s = time.perf_counter() - t0
        train_counts = counted_launches()
        by_step = {}  # a tag's value a step (CaDDN's tb holds "loss" beside the loop's own)
        for line in (out / "tensorboard" / "metrics.jsonl").read_text().splitlines():
            m = json.loads(line)
            by_step.setdefault(m["tag"], {})[m["step"]] = m["value"]
        series = {tag: [v for _, v in sorted(steps.items())] for tag, steps in by_step.items()}
        losses = series["train/loss"]
        step_ms = [1e3 * t for t in series["meta_data/batch_time"]]
        wait_ms = [1e3 * t for t in series["meta_data/data_time"]]
        steps = kitti_run["steps"] * kitti_run["B"] // batch_size
        require(len(losses) == steps and all(np.isfinite(losses)),
                f"{label} train CLI losses {losses}")
        print(f"{label} train CLI (1 epoch of {steps * batch_size} frames at B={batch_size}): "
              f"{train_s:.1f} s; losses {[round(x, 4) for x in losses]}; ms per iteration "
              f"{[round(t, 2) for t in step_ms]}, median after the first "
              f"{statistics.median(step_ms[1:] or step_ms):.2f} ms, waiting for the loader "
              f"{[round(t, 2) for t in wait_ms]} ms")
        ckpt = out / "ckpt" / "checkpoint_epoch_1.pth"
        clear_launches()
        t0 = time.perf_counter()
        result = test_cli.main(["--cfg_file", cfg_rel, "--ckpt", str(ckpt), "--batch_size",
                                "1", "--infer_time", *set_data])
        test_s = time.perf_counter() - t0
        test_counts = counted_launches()
        res_dir = out / "eval" / "epoch_1" / "val" / "default"
        with open(res_dir / "result.pkl", "rb") as f:
            annos = pickle.load(f)
        require([a["frame_id"] for a in annos] == val_ids, f"{label} test CLI: frames")
        # not a gate: eight steps from torch's initial weights leave the
        # BatchNorms' running statistics 92 % at their start (momentum
        # 0.01), so at eval the activations are not normalized and the
        # box decode's exp may overflow
        n_dets = sum(len(a["score"]) for a in annos)
        n_bad = sum(int((~np.isfinite(a["boxes_lidar"]).all(axis=-1)).sum()) for a in annos)
        require("Car_3d/moderate_R40" in result and all(
            np.isfinite(float(v)) for v in result.values()), f"{label} KITTI result dict")
        log = "".join(p.read_text() for p in res_dir.glob("log_eval_*.txt"))
        infer = re.findall(r"Average infer time: ([0-9.]+) ms", log)
        print(f"{label} test CLI (--infer_time, B=1): {test_s:.1f} s, {infer} ms a frame; "
              f"detections per val frame {[len(a['score']) for a in annos]} ({n_bad} of "
              f"{n_dets} with a non-finite box); official "
              f"evaluation " + json.dumps({k: round(float(v), 4) for k, v in result.items()
                                           if k.startswith(("recall/", "Car_3d"))}))
        print(f"{label} CLIs' kernel launches: train {train_counts}, test {test_counts}")
        for name in kernels:
            require(test_counts.get(name, 0) > 0, f"kernel {name} never launched by the "
                    f"{label} test CLI")
        launches = add_launches(train_counts, test_counts)
        if export:
            from pdanet_tpu_torch.tools import export as export_cli

            clear_launches()
            t0 = time.perf_counter()
            path = export_cli.main(["--cfg_file", cfg_rel, "--ckpt", str(ckpt), "--batch_size",
                                    "1", "--verify", *set_data])
            export_counts = counted_launches()
            print(f"{label} export CLI (--ckpt of the train CLI, b1, --verify): "
                  f"{time.perf_counter() - t0:.1f} s, {Path(path).stat().st_size / 1e6:.2f} MB; "
                  f"launches {export_counts}")
            for name in kernels:
                require(export_counts.get(name, 0) > 0, f"kernel {name} never launched by the "
                        f"{label} export CLI")
            return add_launches(launches, export_counts)
    return launches


def dist_train_chain(work, kitti_run, cfg_rel, label):
    """Phases 12-14 and 16-18 (c) as a tail chain (``run_tail``): the yaml
    through ``dist_train.sh`` at world 1 over NCCL (the BatchNorms' global
    moments), one epoch of ``kitti_run``'s root at B = 1, so that several
    such runs share the card; then checked: NCCL at world 1, finite
    losses, one a step, rank 0's launches."""
    def run():
        with DistScript("dist_train.sh", 1, [
                "--cfg_file", cfg_rel, "--epochs", "1", "--batch_size", "1",
                "--num_epochs_to_eval", "0", "--extra_tag", "dp1",
                "--set", "DATA_CONFIG.DATA_PATH", str(kitti_run["root"]),
                *kitti_run.get("set", ())], work) as script:
            train_s = script.wait()
        dp_out = Path(work) / "output" / "kitti_models" / Path(cfg_rel).stem / "dp1"
        log, dp_counts = cli_log(dp_out, "train")
        require("process group: backend nccl, world 1" in log,
                f"{label} dist_train.sh: not NCCL at world 1")
        by_step = {"train/loss": {}, "meta_data/batch_time": {}}  # a value a step
        for line in (dp_out / "tensorboard" / "metrics.jsonl").read_text().splitlines():
            m = json.loads(line)
            if m["tag"] in by_step:
                by_step[m["tag"]][m["step"]] = m["value"]
        dp_losses = [v for _, v in sorted(by_step["train/loss"].items())]
        dp_ms = [1e3 * v for _, v in sorted(by_step["meta_data/batch_time"].items())]
        steps = kitti_run["steps"] * kitti_run["B"]
        require(len(dp_losses) == steps and all(np.isfinite(dp_losses)),
                f"{label} dist_train.sh losses {dp_losses}")
        print(f"{label} train CLI through dist_train.sh (world 1, NCCL, in the tail): "
              f"{train_s:.1f} s; losses {[round(x, 4) for x in dp_losses]}; ms per iteration "
              f"median after the first {statistics.median(dp_ms[1:] or dp_ms):.2f} ms; rank "
              f"0's launches {dp_counts}")
    return label, run


def voxel_export(cfg, model_predict, weights, dev, template, b1, work, cfg_rel, label,
                 kernels):
    """Phases 12-19 (d): the b1 batch, the eager closure's outputs on it and
    ``weights`` saved for the tail (``run_tail``).  Returns the export job
    (``EXPORT_PROGRAMS``, run in the tail's export processes): the b1
    program of ``weights`` through ``serving.export_serving`` and
    ``save_serving``, then reloaded (``reload_process``; ``kernels``, the
    path's, must launch in the program)."""
    import torch

    stem = Path(work) / f"{Path(cfg_rel).stem}_b1"
    torch.save(dict(b1), f"{stem}.batch.pt")
    torch.save({k: v.cpu() for k, v in model_predict(b1).items()}, f"{stem}.want.pt")
    torch.save({k: v.cpu() for k, v in weights.items()}, f"{stem}.weights.pt")
    return dict(label=label, stem=str(stem), kernels=kernels, cfg_rel=cfg_rel,
                cfg_file=str(Path(work) / cfg_rel), root=str(template.root_path))


def export_processes(jobs, sent):
    """The tail's exports: ``jobs`` (``voxel_export``'s) dealt round-robin to
    ``EXPORT_WORKERS`` fresh processes (``EXPORT_PROGRAMS``), each
    exporting its own in turn; a thread a process hands each saved program
    to ``sent`` as it is written.  Returns ``wait()``, which waits for the
    processes and their threads and checks that every program was saved."""
    by_stem = {job["stem"]: job for job in jobs}
    procs, readers, done = [], [], []
    for w in range(min(EXPORT_WORKERS, len(jobs))):
        mine = [job for i, job in enumerate(jobs) if i % EXPORT_WORKERS == w]
        err = tempfile.TemporaryFile("w+")
        proc = subprocess.Popen([sys.executable, "-c", EXPORT_PROGRAMS, json.dumps(mine)],
                                cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True,
                                env=tail_env())

        def read(proc=proc):
            for line in proc.stdout:
                if not line.startswith("{"):  # what else the process prints
                    print(line, end="")
                    continue
                report = json.loads(line)
                job = by_stem[report["stem"]]
                print(f"{job['label']} b1 export (in the tail's export process "
                      f"{report['worker']}): {report['seconds']:.1f} s with the model's build, "
                      f"{report['bytes'] / 1e6:.2f} MB, {report['nodes']} graph nodes")
                done.append(job["stem"])
                sent(job)

        readers.append(threading.Thread(target=read, daemon=True))
        readers[-1].start()
        procs.append((proc, err))

    def wait():
        for proc, err in procs:
            try:
                code = proc.wait(timeout=900)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            err.seek(0)
            require(code == 0, f"an export process failed:\n{err.read()[-6000:]}")
        for reader in readers:
            reader.join()
        require(sorted(done) == sorted(by_stem), f"programs saved {done} of {sorted(by_stem)}")

    return wait


def reload_process():
    """The tail's fresh process (``RELOAD_VOXELS``: torch and the port's
    ops and serving modules only), started before the programs are saved:
    ``send(job)`` hands it a saved program (``voxel_export``'s job),
    ``finish(jobs)`` ends its input, checks each program bit-equal to its
    eager closure and its path's kernels launched, and returns each label's
    launches.  Returns ``(process, send, finish)``."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", RELOAD_VOXELS], cwd=ROOT,
                            stdin=subprocess.PIPE, stdout=out, stderr=err, text=True,
                            env=tail_env())

    def send(job):
        stem = job["stem"]
        proc.stdin.write(json.dumps((f"{stem}.pt2", f"{stem}.batch.pt", f"{stem}.out.pt")) + "\n")
        proc.stdin.flush()

    def finish(jobs):
        import torch

        proc.stdin.close()
        code = proc.wait(timeout=900)
        err.seek(0)
        require(code == 0, f"the programs' fresh process failed:\n{err.read()[-6000:]}")
        out.seek(0)
        *reports, modules = [json.loads(line) for line in out.read().splitlines()]
        require(len(reports) == len(jobs), f"{len(reports)} reports for {len(jobs)} programs")
        require(not any(m.split(".")[1] in ("models", "datasets", "train", "eval", "tools")
                        for m in modules["modules"] if "." in m),
                f"the fresh process imported model code: {modules['modules']}")
        launches = {}
        for job, report in zip(jobs, reports):
            label = job["label"]
            got, want = torch.load(f"{job['stem']}.out.pt"), torch.load(f"{job['stem']}.want.pt")
            for k in want:
                require(torch.equal(got[k], want[k]), f"{label} program: {k} differs from the "
                        f"eager closure's")
            launches[label] = report["launches"]
            print(f"{label} b1 program reloaded in the tail's fresh process ("
                  f"{report['seconds']:.1f} s), bit-equal to the eager closure "
                  f"({int(got['pred_counts'][0])} detections), launches there "
                  f"{report['launches']}")
            for name in job["kernels"]:
                require(launches[label].get(name, 0) > 0, f"kernel {name} never launched in the "
                        f"{label} program")
        print(f"the tail's fresh process: {len(jobs)} programs in "
              f"{time.perf_counter() - t0:.1f} s")
        return launches

    return proc, send, finish


def run_tail(exports, chains):
    """The tail, once every phase has measured, so that its processes run
    beside no measurement: ``chains`` run in threads, ``TAIL_WORKERS`` - 1
    at a time, each (label, fn), fn starting processes, checking them and
    returning their launches (or None); meanwhile ``exports``
    (``voxel_export``'s jobs) go to ``EXPORT_WORKERS`` export processes
    (``export_processes``), and each saved program to one fresh process
    (``reload_process``) as it is written.  A thread samples the card's
    memory in use (every process's, ``mem_get_info``) and the peak is
    printed.  Returns each label's launches (a program's under its phase's
    label)."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    torch.cuda.empty_cache()
    launches = {}
    done, peak = threading.Event(), [0]

    def sample():
        while not done.wait(0.1):
            free, total = torch.cuda.mem_get_info()
            peak[0] = max(peak[0], total - free)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    proc, send, finish = reload_process()
    lock, jobs = threading.Lock(), []

    def sent(job):  # the reload process reports in the order it was sent
        with lock:
            jobs.append(job)
            send(job)

    try:
        wait_exports = export_processes(exports, sent)
        with ThreadPoolExecutor(TAIL_WORKERS - 1) as pool:
            futures = [(label, pool.submit(fn)) for label, fn in chains]
            wait_exports()
            for label, future in futures:
                counts = future.result()
                if counts is not None:
                    launches[label] = add_launches(launches.get(label, {}), counts)
        for label, counts in finish(jobs).items():
            launches[label] = add_launches(launches.get(label, {}), counts)
        done.set()
        sampler.join()
        print(f"the tail's peak device memory in use (every process, sampled every 0.1 s): "
              f"{peak[0] / 2**30:.2f} GiB of {torch.cuda.mem_get_info()[1] / 2**30:.2f}")
        return launches
    finally:
        done.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def cli_run(kitti_run):
    """The ``kitti_run`` of phases 12-14, 16 and 17 (c): phase 9's root, its
    train infos cut to the first ``CLI_TRAIN_FRAMES`` frames
    (``kitti_infos_train_cli.pkl``, written once), which the CLIs and
    dist_train.sh read through ``--set``."""
    root = Path(kitti_run["root"])
    cut = root / "kitti_infos_train_cli.pkl"
    if not cut.exists():
        with open(root / "kitti_infos_train.pkl", "rb") as f:
            infos = pickle.load(f)
        with open(cut, "wb") as f:
            pickle.dump(infos[:CLI_TRAIN_FRAMES], f)
    return {**kitti_run, "B": 1, "steps": CLI_TRAIN_FRAMES,
            "set": ("DATA_CONFIG.INFO_PATH.train", f"['{cut.name}']")}


_CLI_ROOTS = {}  # cli_root's roots by name: phases that share a seed share the root


def cli_root(work, cfg, splits, name, seed):
    """A KITTI root of its own for a phase's CLIs, beside phase 9's in its
    working directory (``name``): ``splits`` frames of phase 9's kind, with
    the yaml's infos and gt database, written once a name (Part-A2 and
    Part-A2-free share theirs).  Returns the ``kitti_run`` dict the CLIs
    take (B 1)."""
    from pdanet_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos

    if name in _CLI_ROOTS:
        return _CLI_ROOTS[name]
    root = Path(work) / name
    t0 = time.perf_counter()
    counts = write_kitti_root(root, list(KITTI_MEAN_SIZES), list(KITTI_MEAN_SIZES.values()),
                              seed=seed, splits=splits)
    create_kitti_infos(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), root, root, workers=4)
    print(f"{name} (c) KITTI root {counts} (frames, boxes, fewest points in the field of "
          f"view) with infos in {time.perf_counter() - t0:.1f} s")
    val_ids = (root / "ImageSets" / "val.txt").read_text().split()
    _CLI_ROOTS[name] = dict(root=root, val_ids=val_ids, B=1, steps=dict(splits)["train"])
    return _CLI_ROOTS[name]


def voxel_phase(dev, work, kitti_run, phase, parent=None):
    """Phases 12-18, on one yaml of ``VOXEL_PHASES`` at full width: (a)
    serving, (b) training, (c) the CLIs, (d) export, (e) the IoU and NMS
    kernels at each K of the path (with ``parent``, that tree's IoU timed
    beside), at the phase's ``VOXEL_DEPTH``.  Returns the launches of its
    main-path runs ((a)'s requests, (b)'s steps, (c)'s CLIs, each counted
    from 0), with the IoU's and the walk's at each K, (e)'s rows by K,
    PV-RCNN's FPS and ball-query rows of (e) (row name, kernel, the key of
    its launches, numbers) (``pv_kernels``), and its tail: (d)'s export and
    the ``dist_train.sh`` job of (c) (``run_tail``, which counts the
    program's request)."""
    import torch

    from pdanet_tpu_torch.config import cfg_from_yaml_file
    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate

    cfg_rel, label, seed = VOXEL_PHASES[phase]
    depth = VOXEL_DEPTH.get(phase, {})
    cfg = cfg_from_yaml_file(str(Path(work) / cfg_rel))
    template = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                               training=False, root_path=str(kitti_run["root"]))
    batch_size = depth.get("batch_size") or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    t0 = time.perf_counter()
    served, weights, predict, b1, out, rec, kernels = voxel_serve(cfg, dev, template, label,
                                                                   seed, depth)
    print(f"phase {phase} (a) serving: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained = voxel_train(cfg, weights, dev, template, label, seed + 100,
                          depth.get("train_steps", VOXEL_TRAIN_STEPS), batch_size,
                          depth.get("crop"), depth.get("train_split", True),
                          depth.get("float64", True))
    print(f"phase {phase} (b) training: {time.perf_counter() - t0:.1f} s")
    clis = {}
    cli = depth.get("cli", True)
    dist_train = cli and depth.get("dist_train", True)
    cli_batch = depth.get("cli_batch", batch_size)
    if cli:
        t0 = time.perf_counter()
        run = (cli_root(work, cfg, depth["cli_root"], f"kitti_cli_{seed}", seed)
               if "cli_root" in depth else cli_run(kitti_run))
        clis = voxel_clis(work, run, cfg_rel, label, cli_batch,
                          export=depth.get("cli_export", False), kernels=kernels)
        print(f"phase {phase} (c) the CLIs: {time.perf_counter() - t0:.1f} s")
    export = voxel_export(cfg, predict, weights, dev, template, b1, work, cfg_rel, label,
                          kernels)
    tail = (export, dist_train_chain(work, run, cfg_rel, label) if dist_train else None)
    t0 = time.perf_counter()
    rows, extra = {}, []
    if depth.get("iou_rows", True):
        for boxes, valid, thresh, what, suppress in kernel_candidates(cfg, out, rec):
            if boxes.shape[1] not in rows:  # Part-A2-free proposes at K 9000 both ways
                rows[boxes.shape[1]] = voxel_kernels(dev, boxes, valid, thresh, label, what,
                                                     suppress, parent)
    if "pv_picks" in out:
        extra = pv_kernels(dev, out, label, VOXEL_SUFFIX[phase])
    elif "rcnn_picks" in out:
        extra = pointrcnn_kernels(dev, out, label, VOXEL_SUFFIX[phase])
    print(f"phase {phase} (e) the kernels at K {sorted(rows)}"
          f"{' and ' + str([r[0] for r in extra]) if extra else ''}: "
          f"{time.perf_counter() - t0:.1f} s")
    del predict, out, rec
    torch.cuda.empty_cache()
    return add_launches(served, trained, clis), rows, extra, tail


def pointpillar_phase(dev, work, kitti_run, parent=None):
    """Phase 12: tools/cfgs/kitti_models/pointpillar.yaml at full width
    (432 x 496 pillars of 0.16 m, 40000 test / 16000 train pillars of 32
    points, 64 BEV channels, 321408 anchors a frame), nothing cut."""
    return voxel_phase(dev, work, kitti_run, 12, parent)


def second_phase(dev, work, kitti_run, parent=None):
    """Phase 13: tools/cfgs/kitti_models/second.yaml at full width (a 0.05 x
    0.05 x 0.1 m grid of 1408 x 1600 x 40 cells, 40000 test / 16000 train
    voxels of 5 points, the sparse backbone's [16, 16, 32, 64, 64] filters
    and 128 output features, a 256-channel BEV map of 200 x 176, 211200
    anchors a frame), nothing cut."""
    return voxel_phase(dev, work, kitti_run, 13, parent)


def voxel_rcnn_phase(dev, work, kitti_run, parent=None):
    """Phase 14: tools/cfgs/kitti_models/voxel_rcnn_car.yaml at full width
    (SECOND's grid and sparse backbone, a 256-channel BEV map, 70400
    anchors a frame, the proposal layer at K 2048 / 9000, a 6 x 6 x 6 RoI
    grid pooled from three sparse levels in 9 x 9 x 9 windows), nothing
    cut; the yaml's batch of 2 to train."""
    return voxel_phase(dev, work, kitti_run, 14, parent)


def second_iou_phase(dev, work, kitti_run, parent=None):
    """Phase 15, SECOND-IoU: tools/cfgs/kitti_models/second_iou.yaml at full
    width (the dense ``VoxelBackBone8x`` over 41 x 1600 x 1408 cells of
    0.05 x 0.05 x 0.1 m, 40000 test / 16000 train voxels of 5 points, a
    256-channel BEV map of 200 x 176 into 512, 211200 anchors; proposals
    at K 1024 to serve and 9000 to train, 100 / 512 RoIs, 128 sampled a
    frame; a 7 x 7 BEV pool over 512 channels, 256-wide FC stacks), at
    ``VOXEL_DEPTH["15a"]``."""
    return voxel_phase(dev, work, kitti_run, "15a", parent)


def multihead_phase(dev, work, kitti_run, parent=None):
    """Phase 15, the multi-head: tools/cfgs/kitti_models/second_multihead.yaml
    at full width (the same dense ladder, three separate heads of one class,
    the per-class NMS at K 4096), at ``VOXEL_DEPTH["15b"]``."""
    return voxel_phase(dev, work, kitti_run, "15b", parent)


def centerpoint_phase(dev, work, kitti_run, parent=None):
    """Phase 16, CenterPoint: tools/cfgs/kitti_models/centerpoint.yaml at
    full width (phase 13's grid, voxels and the residual sparse backbone
    with ``ACTIVE_BUDGETS [16384, 16384, 16384, 8192]``, a 256-channel BEV
    map of 200 x 176, the anchor-free head at 400 x 352, three classes in
    one head, one NMS at K 500), at ``VOXEL_DEPTH[16]``."""
    return voxel_phase(dev, work, kitti_run, 16, parent)


def pv_rcnn_phase(dev, work, kitti_run, parent=None):
    """Phase 17, PV-RCNN: tools/cfgs/kitti_models/pv_rcnn.yaml at full width
    (SECOND's grid and sparse backbone, 70400 anchors a frame of three
    classes, proposals at K 1024 to serve and 9000 to train, 100 / 512
    RoIs, 128 sampled a frame; 2048 keypoints by FPS over the 16384 raw
    points, the BEV map and five ball-query sources; a 6 x 6 x 6 RoI grid
    pooled from the keypoints by the ball query; the final NMS at K 100),
    at ``VOXEL_DEPTH[17]``."""
    return voxel_phase(dev, work, kitti_run, 17, parent)


def pv_rcnn_pp_phase(dev, work, kitti_run, parent=None):
    """Phase 17, PV-RCNN++: tools/cfgs/kitti_models/pv_rcnn_plusplus.yaml at
    full width (PV-RCNN's first stage; 2048 keypoints by FPS over SPC's
    collapse of the raw points on the proposals; VectorPool over the raw
    points, x_conv3, x_conv4 and in the RoI grid pool), at
    ``VOXEL_DEPTH["17b"]``: one b1 request, one train step and the float64
    step, export, and (e) FPS on the collapsed cloud."""
    return voxel_phase(dev, work, kitti_run, "17b", parent)


def parta2_phase(dev, work, kitti_run, parent=None):
    """Phase 18, Part-A2: tools/cfgs/kitti_models/PartA2.yaml at full width
    (SECOND's grid and voxels; the sparse UNetV2 with its 256-channel
    encoded BEV map and the decoder back to the voxels; 211200 anchors of
    three classes; proposals at K 1024 to serve and 9000 to train, 100 /
    512 RoIs, 128 sampled a frame; the 12^3 RoI-aware pool; the final NMS
    at K 100), at ``VOXEL_DEPTH["18a"]``."""
    return voxel_phase(dev, work, kitti_run, "18a", parent)


def parta2_free_phase(dev, work, kitti_run, parent=None):
    """Phase 18, Part-A2-free: tools/cfgs/kitti_models/PartA2_free.yaml at
    full width (the sparse UNetV2 without the BEV map; the point head's
    per-voxel boxes of three classes proposed at K 9000, 100 / 512 RoIs;
    the 12^3 RoI-aware pool of the voxel centres; the final NMS at K 100),
    at ``VOXEL_DEPTH["18b"]``."""
    return voxel_phase(dev, work, kitti_run, "18b", parent)


def pointrcnn_phase(dev, work, kitti_run, parent=None):
    """Phase 19, PointRCNN: tools/cfgs/kitti_models/pointrcnn.yaml at full
    width (16384 sampled points; the PointNet++ MSG backbone 16384 -> 4096 ->
    1024 -> 256 -> 64 with widths up to 512 and its FP decoder back to the
    points at 128 channels; the point-box head's per-point boxes of three
    classes proposed at K 9000, 100 / 512 RoIs, 128 sampled a frame; 512
    points pooled a RoI through the SA stages [128, 32, -1]; the final NMS
    at K 100), at ``VOXEL_DEPTH["19a"]``."""
    return voxel_phase(dev, work, kitti_run, "19a", parent)


def pointrcnn_iou_phase(dev, work, kitti_run, parent=None):
    """Phase 19, PointRCNN-IoU: tools/cfgs/kitti_models/pointrcnn_iou.yaml
    (PointRCNN with ``CLS_SCORE_TYPE`` roi_iou, its yaml's B = 3), at
    ``VOXEL_DEPTH["19b"]``: one b1 request, one train step with the roi_iou
    labels checked, the CLIs and ``dist_train.sh``, export."""
    return voxel_phase(dev, work, kitti_run, "19b", parent)


CADDN_CFG_REL = "cfgs/kitti_models/CaDDN.yaml"
# phase 20's camera root: its splits, and the (H, W) of its images, frame
# after frame in turn (KITTI's 1242 x 375, and 1224 x 370 as a few of its
# frames are), so that a batch of two pads the smaller
CADDN_SPLITS = (("train", 4), ("val", 2))
CADDN_IMAGES = ((375, 1242), (370, 1224))
# CaDDN's float32 stages card against CPU (the depth logits, the voxel
# features, the BEV map, the head's maps), of max(1, |value|): on an H100
# with TF32 off they read 6.38e-06 at most (the depth logits, after the
# DDN's 24 convolutions); the control, the card's stages with TF32 on, read
# 2.21e-04 to 4.83e-02 and must exceed the gate
CADDN_STAGE_TOL = 5e-5
# the float64 step's crop: the image's rows and columns (multiples of the
# depth maps' factor 4; the calibration shifted by them) and the range of
# the voxel grid (the yaml's z range and voxel size: 80 x 80 x 25 voxels)
CADDN_CROP = ((0, 192), (284, 924), (2.0, -6.4, -3.0, 14.8, 6.4, 1.0))
CADDN_CAMERA_KEYS = ("images", "trans_lidar_to_cam", "trans_cam_to_img")


def write_camera_inputs(root, seed=0):
    """CaDDN's camera inputs for every frame of a root ``write_kitti_root``
    wrote: the image at its ``CADDN_IMAGES`` size, a texture on which the
    frame's returns show (brighter the nearer), and the 16-bit depth map
    (metres x 256) of the returns projected into the image, the nearest a
    pixel, 0 elsewhere, both written with zlib (``utils/png.encode_png``)."""
    from pdanet_tpu_torch.utils import calibration_kitti
    from pdanet_tpu_torch.utils.png import encode_png

    training = Path(root) / "training"
    (training / "depth_2").mkdir()
    rs = np.random.RandomState(seed)
    for i, path in enumerate(sorted((training / "velodyne").glob("*.bin"))):
        h, w = CADDN_IMAGES[i % len(CADDN_IMAGES)]
        calib = calibration_kitti.Calibration(str(training / "calib" / f"{path.stem}.txt"))
        uv, depth = calib.lidar_to_img(np.fromfile(path, np.float32).reshape(-1, 4)[:, :3])
        u, v = np.floor(uv[:, 0]).astype(np.int64), np.floor(uv[:, 1]).astype(np.int64)
        seen = (depth > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        dmap = np.full((h, w), np.inf)
        np.minimum.at(dmap, (v[seen], u[seen]), depth[seen])
        dmap[~np.isfinite(dmap)] = 0.0
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * 7 + yy * 3) % 256, (yy * 5 + xx) % 256,
                        rs.randint(0, 256, (h, w))], axis=-1)
        img[dmap > 0] = np.clip(255.0 - 4.0 * dmap[dmap > 0], 0, 255)[:, None]
        (training / "image_2" / f"{path.stem}.png").write_bytes(encode_png(img.astype(np.uint8)))
        (training / "depth_2" / f"{path.stem}.png").write_bytes(
            encode_png(np.round(dmap * 256.0).astype(np.uint16)))


def camera_root(work, cfg, seed):
    """Phase 20's KITTI root beside phase 9's (``CADDN_SPLITS`` frames of
    phase 9's kind with their camera inputs, ``write_camera_inputs``), with
    CaDDN's infos and gt database: the ``kitti_run`` its CLIs take (B 1)."""
    from pdanet_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos

    root = Path(work) / "kitti_camera"
    t0 = time.perf_counter()
    counts = write_kitti_root(root, list(KITTI_MEAN_SIZES), list(KITTI_MEAN_SIZES.values()),
                              seed=seed, splits=CADDN_SPLITS)
    write_camera_inputs(root, seed)
    create_kitti_infos(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), root, root, workers=4)
    print(f"CaDDN camera KITTI root {counts} (frames, boxes, fewest points in the field of "
          f"view), images {CADDN_IMAGES} in turn, with infos in "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(root=root, val_ids=(root / "ImageSets" / "val.txt").read_text().split(), B=1,
                steps=dict(CADDN_SPLITS)["train"])


def camera_batch(cfg, root, indices, training, dev, model, seed=0):
    """Frames ``indices`` of the camera root's split through the port's
    ``KittiDataset`` (the yaml's augmentor on the train split, its
    processors) and collate (images and depth maps padded to the largest):
    the device batch and the host milliseconds a frame."""
    from pdanet_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
    from pdanet_tpu_torch.train import select_device_batch

    ds = KittiDataset(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), training=training,
                      root_path=root)
    np.random.seed(seed)  # the image flip's coins
    frames, host_ms = [], []
    for i in indices:
        t0 = time.perf_counter()
        frames.append(ds[i])
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return select_device_batch(ds.collate_batch(frames), dev, model), host_ms


def caddn_stages(model, batch):
    """CaDDN's stages of a forward at eval: the depth logits, the voxel
    features, the BEV map and the head's maps; and the forward dict."""
    import torch

    with torch.inference_mode():
        vfe = model.vfe(*(batch[k] for k in CADDN_CAMERA_KEYS))
        bev = model.map_to_bev(vfe["voxel_features"])
        out = model.head_forward(bev)
        out["depth_logits"] = vfe["depth_logits"]
    stages = {"depth_logits": vfe["depth_logits"], "voxel_features": vfe["voxel_features"],
              "bev": bev, "cls_preds": out["cls_preds"], "box_preds": out["box_preds"],
              "dir_cls_preds": out["dir_cls_preds"]}
    return stages, out


def stage_gaps(got, want):
    """Each stage's largest |got - want| over max(1, |want|)."""
    return {k: ((got[k].cpu().double() - w.double()).abs()
                / w.double().abs().clamp(min=1.0)).max().item() for k, w in want.items()}


def caddn_card_vs_cpu(cfg, model, weights, template, b1, result, label):
    """Phase 20 (a): request 0's frame in float32 on the card against the
    CPU (plain versions; the CPU's self-IoU the plain version on the card,
    ``plain_iou_on``): every stage (``caddn_stages``) within
    ``CADDN_STAGE_TOL`` of max(1, |value|), the card's stages with TF32 on
    (the control) beyond it, and the detections of the CPU's
    post-processing on the card's forward paired box for box with the
    card's (those of the CPU's own forward reported beside them).  Returns
    the card's forward."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors import get_post_processor

    card, out_card = caddn_stages(model, b1)
    with tf32_on():
        control, _ = caddn_stages(model, b1)
    cpu_model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template, device="cpu")
    cpu_model.load_state_dict(weights)
    t0 = time.perf_counter()
    cpu, out_cpu = caddn_stages(cpu_model.eval(), {k: v.cpu() for k, v in b1.items()})
    with torch.inference_mode(), plain_iou_on(b1["images"].device):
        post_cpu = get_post_processor(cfg.MODEL.NAME)(out_cpu, cfg.MODEL)
        # the CPU's post-processing on the card's forward: the seeded head's
        # scores lie so close that the NMS_POST_MAXSIZE cut of the CPU's own
        # forward, ~1e-7 apart, keeps other boxes near its end
        on_card = get_post_processor(cfg.MODEL.NAME)(
            {k: v.cpu() for k, v in out_card.items()}, cfg.MODEL)
    cpu_s = time.perf_counter() - t0
    gaps, control_gaps = stage_gaps(card, cpu), stage_gaps(control, cpu)
    pairs, n_g, n_c, gap_c, gap_s = match_detections(result, on_card)
    own = match_detections(result, post_cpu)
    print(f"{label} float32 frame, card vs CPU ({cpu_s:.1f} s on the CPU), of max(1, |value|): "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()) + "; the control (TF32 on): "
          + ", ".join(f"{k} {v:.3g}" for k, v in control_gaps.items())
          + f"; detections {n_g} vs {n_c} of the CPU's post-processing on the card's forward, "
          f"{pairs} paired by mutual nearest centre (largest centre distance {gap_c:.3g} m, "
          f"score {gap_s:.3g}); of the CPU's own forward {own[2]}, {own[0]} paired (largest "
          f"centre distance {own[3]:.3g} m, score {own[4]:.3g})")
    require(max(gaps.values()) <= CADDN_STAGE_TOL,
            f"{label} stages card vs CPU beyond {CADDN_STAGE_TOL}: {gaps}")
    require(max(control_gaps.values()) > CADDN_STAGE_TOL,
            f"{label}: the TF32 control within the gate {CADDN_STAGE_TOL}: {control_gaps}")
    require(n_g == n_c == pairs and gap_c <= 1e-3 and gap_s <= 1e-4,
            f"{label} float32 detections card vs CPU not paired box for box")
    return out_card


def caddn_crop(cfg, batch):
    """Frame 0 of a device batch cut to ``CADDN_CROP``: its image rows and
    columns, the depth map's at a quarter, the camera matrix's pixels
    shifted, the 2-D boxes shifted (padding rows stay zero); and the yaml
    with the crop's range."""
    (r0, r1), (c0, c1), pcr = CADDN_CROP
    one = {k: v[:1].clone() for k, v in batch.items()}
    one["images"] = one["images"][:, r0:r1, c0:c1].contiguous()
    one["depth_maps"] = one["depth_maps"][:, r0 // 4:r1 // 4, c0 // 4:c1 // 4].contiguous()
    c2i = one["trans_cam_to_img"]
    c2i[:, 0] -= c0 * c2i[:, 2]
    c2i[:, 1] -= r0 * c2i[:, 2]
    boxes = one["gt_boxes2d"]
    valid = (boxes != 0).any(dim=-1, keepdim=True)
    shift = boxes.new_tensor([c0, r0, c0, r0])
    one["gt_boxes2d"] = boxes.where(~valid, boxes - shift)
    crop_cfg = copy.deepcopy(cfg)
    crop_cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(pcr)
    return one, crop_cfg


def caddn_train(cfg, weights, dev, run, label):
    """Phase 20 (b): one float32 step at the yaml's B = 4 on the camera
    root's train frames (two image sizes, padded; the image flip drawn),
    its time and peak memory, no self-IoU run; then one float64 step on
    ``CADDN_CROP`` of frame 0 on the card against the CPU (the sampler's
    backward on the card adds by atomics: rounding, not bits): loss within
    1e-10 relative, gradient leaves within 1e-8 of their scale, statistics
    within 1e-10.  Returns the step's launches."""
    import torch

    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.train import build_optimizer_and_schedule, make_train_step

    ocfg = cfg.OPTIMIZATION
    B = int(ocfg.BATCH_SIZE_PER_GPU)

    def train_model(device, dtype, model_cfg):
        template = DatasetTemplate(dataset_cfg=model_cfg.DATA_CONFIG,
                                   class_names=cfg.CLASS_NAMES, training=False,
                                   root_path=str(run["root"]))
        model = build_network(model_cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template,
                              device=device)
        model.load_state_dict(weights)
        model = model.to(dtype)
        optimizer, schedule = build_optimizer_and_schedule(
            model, ocfg, total_iters_each_epoch=3712 // B, total_epochs=ocfg.NUM_EPOCHS)
        return model, make_train_step(model, optimizer, schedule)

    model, step = train_model(dev, torch.float32, cfg)
    batch, host_ms = camera_batch(cfg, run["root"], range(B), True, dev, model, seed=20)
    print(f"{label} train frames: host dataset and processors {[round(t, 1) for t in host_ms]} "
          f"ms a frame; images {tuple(batch['images'].shape)}, depth maps "
          f"{tuple(batch['depth_maps'].shape)}, gt boxes "
          f"{(batch['gt_boxes'][..., 7] > 0).sum(dim=1).tolist()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    clear_launches()
    with RecordIoUShapes() as rec:
        t0 = time.perf_counter()
        loss, tb = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = counted_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    require(np.isfinite(loss.item()) and _grads_finite(model), f"{label} step: not finite")
    require(not rec.shapes, f"{label} training ran a self-IoU: {rec.shapes}")
    print(f"{label} train float32 B={B}: loss {loss.item():.4f} (ddn_loss "
          f"{float(tb['ddn_loss']):.4f}); {ms:.2f} ms (the first step of a process); peak "
          f"memory {peak:.2f} GiB; launches {launches}")
    del model, step
    torch.cuda.empty_cache()

    one, crop_cfg = caddn_crop(cfg, batch)
    one = {k: v.double() if v.is_floating_point() else v for k, v in one.items()}
    res = []
    for device in (dev, torch.device("cpu")):
        model, step = train_model(device, torch.float64, crop_cfg)
        t0 = time.perf_counter()
        loss, _ = step({k: v.to(device) for k, v in one.items()})
        res.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                    {n: b.cpu() for n, b in model.named_buffers() if "running" in n},
                    time.perf_counter() - t0))
        del model, step
    (l_g, g_g, s_g, t_g), (l_c, g_c, s_c, t_c) = res
    rel = abs(l_g - l_c) / abs(l_c)
    errs = _leaf_errors(g_g, g_c, floor=1e-6)
    stat_err = max((s_g[n] - s_c[n]).abs().max().item() for n in s_c)
    print(f"{label} float64 step B=1 on the crop {CADDN_CROP} (images "
          f"{tuple(one['images'].shape)}), card vs CPU ({t_g:.1f} s / {t_c:.1f} s): loss "
          f"{l_g:.17g} vs {l_c:.17g} (rel {rel:.3g}); gradient leaves within {errs[0][0]:.3g} "
          f"of their scale at worst ({errs[0][1]}), deciles {_deciles(errs)}; statistics "
          f"within {stat_err:.3g}")
    require(rel <= 1e-10, f"{label} float64 loss card vs CPU rel {rel}")
    require(errs[0][0] <= 1e-8, f"{label} float64 gradients card vs CPU: {errs[:3]}")
    require(stat_err <= 1e-10, f"{label} float64 statistics card vs CPU {stat_err}")
    return launches


def caddn_phase(dev, work, kitti_run, parent=None):
    """Phase 20: tools/cfgs/kitti_models/CaDDN.yaml at full width (375 x
    1242 images; the DDN at width 256, 80 LID bins; the frustum 80 x 94 x
    311 x 64 sampled into a 25 x 376 x 280 x 64 voxel grid; Conv2DCollapse
    to 64 channels; the BEV backbone's [10, 10, 10] layers; 157920 anchors;
    the single-class NMS at K 4096), seeded weights, float32, TF32 off, on
    a camera root of its own (``camera_root``).  (a) A b1 and a b2 request
    (two image sizes, padded), card vs CPU (``caddn_card_vs_cpu``); (b) a
    B = 4 step and the float64 step on a crop (``caddn_train``); (c) the
    train and test CLIs, ``dist_train.sh`` in the tail; the export CLI and
    the serving spec refuse CaDDN as the JAX package does; (e) the IoU and
    the NMS at K 4096 on frame 0's candidates.  Returns what ``voxel_phase``
    returns, with no export job."""
    import torch

    from pdanet_tpu_torch.config import cfg_from_yaml_file
    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.models.detectors import CaDDN
    from pdanet_tpu_torch.serving import make_predict_fn, serving_input_spec
    from pdanet_tpu_torch.tools import export as export_cli

    label = "CaDDN"
    cfg = cfg_from_yaml_file(str(Path(work) / CADDN_CFG_REL))
    run = camera_root(work, cfg, seed=2000)
    template = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                               training=False, root_path=str(run["root"]))
    t0 = time.perf_counter()
    model = init_random_weights(build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template,
                                              device=dev), seed=0)
    weights = copy.deepcopy(model.state_dict())
    predict = make_predict_fn(model, cfg.MODEL)
    requests, host_ms = [], []
    for indices in ((0,), (0, 1)):
        batch, ms = camera_batch(cfg, run["root"], indices, False, dev, model)
        batch.pop("gt_boxes"), batch.pop("gt_boxes2d"), batch.pop("depth_maps")
        requests.append(batch)
        host_ms += ms
    for batch in requests:  # warm-up: cuDNN's algorithms at each shape
        predict(batch)
    torch.cuda.synchronize()
    print(f"{label} frames: host dataset and processors (test split) "
          f"{[round(t, 1) for t in host_ms]} ms a frame; the requests' images "
          f"{[tuple(r['images'].shape) for r in requests]}")
    clear_launches()
    results, peaks = [], []
    with RecordIoUShapes(keep_boxes=True) as rec:
        for batch in requests:
            torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            res = predict(batch)
            torch.cuda.synchronize()
            results.append((batch_frames(batch), (time.perf_counter() - t1) * 1e3, res))
            peaks.append(round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2))
    served = counted_launches()
    K = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE)
    for i, (B, ms, res) in enumerate(results):
        for key, val in res.items():
            require(tuple(val.shape[:1]) == (B,) and bool(torch.isfinite(val.float()).all()),
                    f"{label} request {i}: {key}")
        print(f"{label} request {i}: B={B} latency {ms:.2f} ms (float32, TF32 off), "
              f"detections {res['pred_counts'].tolist()}")
    kept = [k.sum(dim=1).tolist() for k in rec.keeps]
    print(f"{label} kernel launches in the served requests: {served}; the self-IoU's inputs "
          f"{rec.shapes}, candidates kept by the walks {kept} of the valid "
          f"{[v.sum(dim=1).tolist() for v, _ in rec.walks]}; peak memory a request {peaks} GiB")
    require({s[1] for s in rec.shapes} == {K}, f"{label} self-IoU at {rec.shapes}, not K {K}")
    for name in VOXEL_KERNELS:
        require(served.get(f"{name}_k{K}", 0) > 0, f"kernel {name} never launched at K {K} on "
                f"the {label} path")
    b1 = requests[0]
    lat, enq = request_ms(predict, b1, reps=3)
    print(f"{label} b1 request: median latency {lat:.2f} ms, host enqueue {enq:.2f} ms (3 "
          f"after warm-up, TF32 off)")
    print_split(f"a {label} b1 request under torch.profiler (TF32 off)",
                device_split(lambda: predict(b1)))
    out = caddn_card_vs_cpu(cfg, model, weights, template, b1, results[0][2], label)
    del model, predict
    torch.cuda.empty_cache()
    print(f"phase 20 (a) serving: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained = caddn_train(cfg, weights, dev, run, label)
    print(f"phase 20 (b) training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    clis = voxel_clis(work, run, CADDN_CFG_REL, label, int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU))
    for refuse in (lambda: serving_input_spec(cfg, 1, CaDDN),
                   lambda: export_cli.main(["--cfg_file", str(Path(work) / CADDN_CFG_REL),
                                            "--random_init"])):
        try:
            refuse()
        except NotImplementedError as e:
            require("camera-family CaDDN" in str(e), f"{label}: refused for another reason: {e}")
        else:
            raise AssertionError(f"{label}: the serving export did not refuse the camera inputs")
    print(f"{label}: the serving spec and the export CLI refuse the camera inputs, as the JAX "
          f"package's serving does")
    print(f"phase 20 (c) the CLIs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = {}
    for boxes, valid, thresh, what, suppress in kernel_candidates(cfg, out, rec):
        rows[boxes.shape[1]] = voxel_kernels(dev, boxes, valid, thresh, label, what, suppress,
                                             parent)
    print(f"phase 20 (e) the kernels at K {sorted(rows)}: {time.perf_counter() - t0:.1f} s")
    del out, rec
    torch.cuda.empty_cache()
    chain = dist_train_chain(work, run, CADDN_CFG_REL, label)
    return add_launches(served, trained, clis), rows, [], (None, chain)


# phase 20b: variants of shipped yamls that the JAX package builds and no
# shipped yaml names, each built in memory: label -> (yaml, variant, seed of
# its frames).  ``dynamic_pillar``: pointpillar.yaml's VFE DynamicPillarVFE;
# ``dynamic_mean``: second.yaml over DynamicMeanVFE and the dense
# VoxelBackBone8x; the two dynamic ones with the voxelizer's placeholder
# (the grid alone), as the reference's dynamic yamls have it; ``atss``:
# second.yaml with TARGET_ASSIGNER_CONFIG.NAME ATSS (TOPK 9);
# ``dense_pool``: voxel_rcnn_car.yaml over the dense VoxelBackBone8x, whose
# RoI grid pool is the dense-grid NeighborGridPool
VARIANTS = {"PointPillar-dynamic": (PP_CFG_REL, "dynamic_pillar", 2010),
            "SECOND-dynamic": (SECOND_CFG_REL, "dynamic_mean", 2020),
            "SECOND-ATSS": (SECOND_CFG_REL, "atss", 2030),
            "Voxel-RCNN-dense": (VRCNN_CFG_REL, "dense_pool", 2040)}
VARIANT_SUFFIX = {"PointPillar-dynamic": "_pointpillar_dynamic",
                  "SECOND-dynamic": "_second_dynamic", "Voxel-RCNN-dense": "_voxel_rcnn_dense"}
ATSS_TOPK = 9


def variant_cfg(work, cfg_rel, variant):
    """The yaml of ``cfg_rel`` changed into ``variant`` (``VARIANTS``)."""
    from pdanet_tpu_torch.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(Path(work) / cfg_rel))
    model = cfg.MODEL
    if variant.startswith("dynamic"):
        for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
            if proc.NAME == "transform_points_to_voxels":
                proc.NAME = "transform_points_to_voxels_placeholder"
    if variant == "dynamic_pillar":
        model.VFE.NAME = "DynamicPillarVFE"
    elif variant == "dynamic_mean":
        model.VFE.NAME = "DynamicMeanVFE"
    if variant in ("dynamic_mean", "dense_pool"):
        model.BACKBONE_3D.NAME = "VoxelBackBone8x"
    if variant == "atss":
        model.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.update(NAME="ATSS", TOPK=ATSS_TOPK)
    return cfg


def crop_of(cfg, root):
    """``cfg`` on ``DENSE_CROP`` and its dataset template."""
    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate

    crop_cfg = copy.deepcopy(cfg)
    crop_cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(DENSE_CROP)
    return crop_cfg, DatasetTemplate(dataset_cfg=crop_cfg.DATA_CONFIG,
                                     class_names=cfg.CLASS_NAMES, training=False,
                                     root_path=str(root))


def dense_pool_card_vs_cpu(cfg, weights, dev, root, frames, label):
    """Voxel-RCNN over the dense ladder, frame 0 on ``DENSE_CROP`` in float32
    on the card against the CPU: the first stage's logits within 2e-3;
    then on the card's RoIs and their grid points (``get_dense_grid_points``
    on the card), each device's dense levels pooled by the dense-grid
    ``NeighborGridPool`` and refined: the pooled features and ``rcnn_cls``
    / ``rcnn_reg`` within 2e-3 of max(1, |value|)."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors.second import SECOND
    from pdanet_tpu_torch.models.roi_heads.voxelrcnn_head import get_dense_grid_points

    crop_cfg, template = crop_of(cfg, root)
    models = []
    for device in (dev, torch.device("cpu")):
        model = build_network(crop_cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template,
                              device=device)
        model.load_state_dict(weights)
        models.append(model.eval())
    b1, _ = voxel_batch(crop_cfg, frames[:1], False, dev, models[0])
    b1.pop("gt_boxes")
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = models[0].forward_batch(b1)
        rois = out["rois"]
        grid = models[0].roi_head.grid
        grid_xyz = get_dense_grid_points(rois, grid).reshape(1, -1, 3)
        firsts, pooled, refined = [], [], []
        for model, device in zip(models, (dev, torch.device("cpu"))):
            batch = {k: v.to(device) for k, v in b1.items()}
            first = SECOND.forward(model, batch["voxels"], batch["voxel_coords"],
                                   batch["voxel_num_points"])
            firsts.append(first["batch_cls_preds"].cpu())
            p = model.roi_head.pool(first["multi_scale_3d_features"], grid_xyz.to(device))
            pooled.append(p.cpu())
            refined.append([t.cpu() for t in model.roi_head.refine(
                p.reshape(1, rois.shape[1], -1))])

    def gap(a, b):
        return ((a.double() - b.double()).abs() / b.double().abs().clamp(min=1.0)).max().item()

    gaps = {"first-stage logits": gap(*firsts), "pooled": gap(*pooled),
            "rcnn_cls": gap(refined[0][0], refined[1][0]),
            "rcnn_reg": gap(refined[0][1], refined[1][1])}
    print(f"{label} float32 frame on the crop {list(DENSE_CROP)}, card vs CPU "
          f"({time.perf_counter() - t0:.1f} s), on the card's {rois.shape[1]} RoIs and their "
          f"{grid_xyz.shape[1]} grid points: " + ", ".join(f"{k} {v:.3g}"
                                                          for k, v in gaps.items()))
    require(max(gaps.values()) <= 2e-3, f"{label} card vs CPU on the crop: {gaps}")


def atss_card_vs_cpu(cfg, weights, dev, template, frames, label):
    """SECOND with the ATSS assigner: one float32 step at the yaml's B = 4
    (finite loss and gradients); then the ATSS targets of those frames'
    gt on the card against the CPU, the CPU fed the card's anchor x gt IoU
    (the two devices' float32 rotated overlaps round apart, and a forced
    claim's argmax may tie within that): labels and weights equal,
    regression targets within 1e-5.  Returns the step's launches."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.dense_heads import atss_assigner
    from pdanet_tpu_torch.train import build_optimizer_and_schedule, make_train_step

    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template, device=dev)
    model.load_state_dict(weights)
    ocfg = cfg.OPTIMIZATION
    B = int(ocfg.BATCH_SIZE_PER_GPU)
    optimizer, schedule = build_optimizer_and_schedule(
        model, ocfg, total_iters_each_epoch=3712 // B, total_epochs=ocfg.NUM_EPOCHS)
    step = make_train_step(model, optimizer, schedule)
    np.random.seed(2031)  # shuffle_points
    batch, _ = voxel_batch(cfg, frames[:B], True, dev, model)
    clear_launches()
    t0 = time.perf_counter()
    loss, tb = step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = counted_launches()
    require(np.isfinite(loss.item()) and _grads_finite(model), f"{label} step: not finite")
    anchors, gt = model._anchors(), batch["gt_boxes"]
    fed = [atss_assigner._anchor_gt_iou(anchors, g[:, :7], False) for g in gt]
    t1 = time.perf_counter()
    card = atss_assigner.atss_assign_targets(anchors, gt, ATSS_TOPK, model.box_coder)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t1) * 1e3
    own = atss_assigner._anchor_gt_iou
    queue = [f.cpu() for f in fed]
    atss_assigner._anchor_gt_iou = lambda a, g, mh: queue.pop(0)
    try:
        cpu = atss_assigner.atss_assign_targets(anchors.cpu(), gt.cpu(), ATSS_TOPK,
                                                model.box_coder)
    finally:
        atss_assigner._anchor_gt_iou = own
    for key in ("box_cls_labels", "reg_weights"):
        require(torch.equal(card[key].cpu(), cpu[key]), f"{label} ATSS {key} card vs CPU")
    err = (card["box_reg_targets"].cpu() - cpu["box_reg_targets"]).abs().max().item()
    require(err <= 1e-5, f"{label} ATSS regression targets card vs CPU {err}")
    pos = (card["box_cls_labels"] > 0).sum(dim=1).tolist()
    require(min(pos) > 0, f"{label}: a frame with no ATSS positive {pos}")
    print(f"{label} train float32 B={B}: loss {loss.item():.4f}, {ms:.2f} ms (the first step "
          f"of its model); ATSS (TOPK {ATSS_TOPK}) over {anchors.shape[0]} anchors x "
          f"{gt.shape[1]} gt rows a frame, {card_ms:.1f} ms on the card: positives a frame "
          f"{pos}, labels and weights equal card vs CPU (the CPU fed the card's IoU), "
          f"targets within {err:.3g}; launches {launches}")
    return launches


def variants_phase(dev, work, kitti_run, parent=None):
    """Phase 20b: the ``VARIANTS`` at full width, seeded weights (a
    two-stage model's box conv scaled by ``BOX_CONV_SCALE``), float32, TF32
    off, on phase 9's kind of frames: each one b1 request through the
    serving closure, the IoU and NMS kernels launched at every K of its
    path; card vs CPU: PointPillar-dynamic's frame at full width
    (``anchors_card_vs_cpu``), SECOND-dynamic's on ``DENSE_CROP``, Voxel-RCNN-
    dense's first stage and RoI head on ``DENSE_CROP``
    (``dense_pool_card_vs_cpu``), SECOND-ATSS's one step and its targets
    (``atss_card_vs_cpu``; its request is SECOND's forward, phase 13's);
    (e) the IoU and the NMS on the dynamic variants' and Voxel-RCNN-dense's
    request candidates.  Returns each variant's launches and rows."""
    import torch

    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.serving import make_predict_fn

    out_runs = []
    for label, (cfg_rel, variant, seed) in VARIANTS.items():
        t0 = time.perf_counter()
        cfg = variant_cfg(work, cfg_rel, variant)
        template = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                                   training=False, root_path=str(kitti_run["root"]))
        model = init_random_weights(build_network(cfg.MODEL, len(cfg.CLASS_NAMES),
                                                  dataset=template, device=dev), seed=0)
        if "ROI_HEAD" in cfg.MODEL:
            with torch.no_grad():
                model.dense_head.conv_box.weight.mul_(BOX_CONV_SCALE)
        weights = copy.deepcopy(model.state_dict())
        predict = make_predict_fn(model, cfg.MODEL)
        frames = voxel_frames(seed, 4, cfg.CLASS_NAMES)
        b1, host_ms = voxel_batch(cfg, frames[:1], False, dev, model)
        b1.pop("gt_boxes")
        predict(b1)  # warm-up
        torch.cuda.synchronize()
        clear_launches()
        with RecordIoUShapes(keep_boxes=True) as rec:
            t1 = time.perf_counter()
            res = predict(b1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        launches = counted_launches()
        for key, val in res.items():
            require(bool(torch.isfinite(val.float()).all()), f"{label}: {key} not finite")
        ks = serve_ks(cfg)
        require({s[1] for s in rec.shapes} == ks, f"{label} self-IoU at {rec.shapes}, not K "
                f"{sorted(ks)}")
        for K in ks:
            for name in VOXEL_KERNELS:
                require(launches.get(f"{name}_k{K}", 0) > 0,
                        f"kernel {name} never launched at K {K} on the {label} path")
        lat, enq = request_ms(predict, b1, reps=3)
        print(f"{label} ({cfg_rel}, {variant}): host processors {host_ms[0]:.1f} ms, the "
              f"request {describe_batch(b1)}; b1 latency {ms:.2f} ms, then median {lat:.2f} "
              f"ms (enqueue {enq:.2f}), detections {res['pred_counts'].tolist()}; launches "
              f"{launches}")
        with torch.inference_mode():
            first = model.forward_batch(b1) if "ROI_HEAD" not in cfg.MODEL else None
        del predict
        torch.cuda.empty_cache()
        if variant == "dynamic_pillar":
            anchors_card_vs_cpu(cfg, model, weights, template, [b1], [(1, ms, res)], label)
        elif variant == "dynamic_mean":
            crop_cfg, crop_template = crop_of(cfg, kitti_run["root"])
            crop_model = build_network(crop_cfg.MODEL, len(cfg.CLASS_NAMES),
                                       dataset=crop_template, device=dev)
            crop_model.load_state_dict(weights)
            crop_b1, _ = voxel_batch(crop_cfg, frames[:1], False, dev, crop_model)
            crop_b1.pop("gt_boxes")
            crop_res = make_predict_fn(crop_model, cfg.MODEL)(crop_b1)
            anchors_card_vs_cpu(crop_cfg, crop_model, weights, crop_template, [crop_b1],
                                [(1, 0.0, crop_res)], f"{label} on the crop {list(DENSE_CROP)}")
            del crop_model
        elif variant == "atss":
            del model
            torch.cuda.empty_cache()
            launches = add_launches(launches, atss_card_vs_cpu(cfg, weights, dev, template,
                                                               frames, label))
        else:
            dense_pool_card_vs_cpu(cfg, weights, dev, kitti_run["root"], frames, label)
        rows = {}
        if label in VARIANT_SUFFIX:
            if first is None:  # a two-stage model: its request's walks as it gave them
                cands = [(rec.boxes[i], *rec.walks[i], f"request 0's candidates at K "
                          f"{rec.boxes[i].shape[1]}", False) for i in range(len(rec.boxes))]
            else:
                cands = kernel_candidates(cfg, first, rec)
            for boxes, valid, thresh, what, suppress in cands:
                rows[boxes.shape[1]] = voxel_kernels(dev, boxes, valid, float(thresh), label,
                                                     what, suppress, parent)
        out_runs.append((label, VARIANT_SUFFIX.get(label), launches, rows))
        del first, rec
        torch.cuda.empty_cache()
        print(f"phase 20b {label}: {time.perf_counter() - t0:.1f} s")
    return out_runs

# Phase 21: the rest of the IASSD surface.  label -> the CLIs' --set pairs
# on PDA-SSD.yaml (key-wise dict overrides: the yaml has none of the keys)
IASSD_VARIANTS = {
    # SA1 by FS, 512 F-FPS + 512 D-FPS picks: the shipped 1024 centres
    "V1": ("MODEL.BACKBONE_3D.SA_CONFIG",
           "{'SAMPLE_METHOD_LIST': [['D-FPS'], ['FS'], ['ctr_aware'], ['ctr_aware'], [], []], "
           "'NPOINT_LIST': [[4096], [512], [512], [256], [-1], [256]], "
           "'PDA_VARIANT': 'no_global', 'PROPOSAL_AWARE_CBAM': True}",
           "MODEL.POINT_HEAD", "{'IOU_FC': [256, 256]}"),
    # SA0 by the radial-sector FPS, 16384 -> 4096 over four sectors
    "V2": ("MODEL.BACKBONE_3D.SA_CONFIG",
           "{'SAMPLE_METHOD_LIST': [['ds_FPS'], ['D-FPS'], ['ctr_aware'], ['ctr_aware'], [], []], "
           "'POINTFORMER_IMPL': 'encoder_layer'}",
           "MODEL.POINT_HEAD", "{'IOU_FC': [256, 256]}"),
}
IASSD_REQUESTS = {"V1": (1, 2), "V2": (1,)}  # the batch sizes served card vs CPU
IASSD_KERNELS = {"V1": ("fps", "fps_features", "ball_query", "neighbor_attention",
                        "neighbor_attention_bwd", "neighbor_attention_bf16"),
                 "V2": ("fps", "ball_query", "neighbor_attention", "neighbor_attention_bwd",
                        "neighbor_attention_bf16")}
# SA1's F-FPS: B, N, C (xyz and SA0's 64 channels), npoint; then duplicated
# rows, and rows too wide for shared memory (read from global memory)
FFPS_SHAPES = ((1, 4096, 67, 512, False), (2, 4096, 67, 512, False),
               (2, 4096, 67, 512, True), (1, 20000, 300, 64, False))
NO_GLOBAL_ATTN = (("SA1 no_global", 1024, 48), ("SA2 no_global", 512, 96))


def ffps_rows(seed, B, N, C, dup=False):
    """F-FPS rows like SA1's: the xyz of a LiDAR-like cloud and C - 3
    ReLU'd channels; ``dup`` repeats the first half of the rows."""
    rs = np.random.RandomState(seed)
    xyz = lidar_like_cloud(seed, B, N)[..., :3]
    rows = np.concatenate([xyz, np.maximum(rs.randn(B, N, C - 3), 0)], -1).astype(np.float32)
    if dup:
        rows[:, N // 2:] = rows[:, :N - N // 2]
    return rows


def check_ffps(dev):
    """The F-FPS kernel against its plain version on the card at
    ``FFPS_SHAPES``: equal indices, its time per serial step, and at SA1's
    shape its time, the plain version's and its bound (3 C operations a
    point and step, the plain version timed at B = 1 only: ~0.65 s a
    call).  Returns the kernel's row of numbers."""
    import torch

    from pdanet_tpu_torch.ops import sampling

    st = {"max_abs_err": 0.0, "library_ms": None}
    for B, N, C, m, dup in FFPS_SHAPES:
        rows = torch.from_numpy(ffps_rows(2100 + B, B, N, C, dup)).to(dev)
        got = sampling.farthest_point_sample_features_cuda(rows, m)
        want = sampling.farthest_point_sample_features_plain(rows, m)
        require(torch.equal(got, want), f"F-FPS B={B} N={N} C={C} npoint={m}: indices differ "
                f"from the plain version")
        kern = cuda_ms(lambda: sampling.farthest_point_sample_features_cuda(rows, m))
        line = (f"fps_features B={B} N={N} C={C} npoint={m}{' duplicated rows' if dup else ''}: "
                f"equal; launch shape {sampling.fps_features_config(N, C)}; kernel {kern:.4f} ms, "
                f"{1e3 * kern / m:.2f} us a step")
        if B == 1 and N == 4096:
            plain = cuda_ms(lambda: sampling.farthest_point_sample_features_plain(rows, m),
                            reps=PLAIN_REPS, warmup=1)
            bnd = bound(rows.numel() * 4 + B * m * 4, 3 * C * N * m * B, F32_OPS_PER_S)
            line += (f", plain {plain:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), kernel at "
                     f"{100 * bnd[0] / kern:.2f} % of it")
            st.update(ms=kern, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1])
        print(line)
    return st


def check_no_global_attention(dev):
    """The attention kernels at no_global's head widths (d_model 3d: hd 48
    at SA1, 96 at SA2), K 16 and 32, float32 and bfloat16, against the
    plain versions on the card: the forward at b1 and the backward at B =
    4, each timed at K 32 beside SDPA, with its bound."""
    import torch

    from pdanet_tpu_torch.ops import attention

    gen = torch.Generator(device=dev).manual_seed(21)
    tols = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
    for label, M, hd in NO_GLOBAL_ATTN:
        for K in (16, 32):
            for dt in (torch.float32, torch.bfloat16):
                name = "bf16" if dt == torch.bfloat16 else "f32"
                for B, bwd in ((1, False), (4, True)):
                    R, D = B * M * K, 4 * hd
                    t = [torch.randn(R, D, generator=gen, device=dev).to(dt) for _ in range(4)]
                    if bwd:
                        def kern():
                            return attention.neighbor_attention_flat_bwd_cuda(*t, K, 4, hd)

                        def plain():
                            return attention.neighbor_attention_flat_bwd_plain(*t, K, 4, hd)
                        lib = sdpa_backward(*t, K, 4, hd)
                        err = grad_err(kern(), plain(), dt)
                    else:
                        def kern():
                            return attention.neighbor_attention_flat_cuda(*t[:3], K, 4, hd)

                        def plain():
                            return attention.neighbor_attention_flat_plain(*t[:3], K, 4, hd)
                        lib = sdpa_forward(*t[:3], K, 4, hd)[0]
                        err = (kern().float() - plain().float()).abs().max().item()
                    what = (f"attention{' backward' if bwd else ''} {label} B={B} K={K} hd={hd} "
                            f"{name}")
                    require(err <= tols[dt], f"{what}: err {err} > {tols[dt]}")
                    metric = "max err / max |grad|" if bwd and name == "bf16" else "max abs err"
                    line = f"{what}: {metric} {err:.3g}"
                    if K == 32:
                        kern_ms, lib_ms = in_turns(kern, lib)
                        plain_ms = cuda_ms(plain, reps=PLAIN_REPS, warmup=1)
                        bnd = attention_bound(R, K, 4, hd, dt, bwd=bwd)
                        line += (f"; kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
                                 f"{lib_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), kernel at "
                                 f"{100 * bnd[0] / kern_ms:.1f} % of it")
                    print(line)
                    del t, lib


def ellipsoid_margin(xyz, centers, radius, nsample):
    """Per centre, the least distance from a surface of the ellipsoid
    query over the points, in float64 on the CPU: min |d^2 / r^2 - 1| and
    |val - 1| (a float32 covariance or eigenvector an ulp apart moves a
    point that near across)."""
    from pdanet_tpu_torch.ops.ellipsoid_query import query_frame

    _, val, d2 = query_frame(radius, nsample, xyz.double().cpu(), centers.double().cpu())
    return (d2 / (radius * radius) - 1).abs().minimum((val - 1).abs()).amin(-1)


def check_iassd_ops(dev):
    """``ry_fps`` (with y = 0 and x = y = 0 points), the ellipsoid query,
    the dilated query and ``nms_rotated`` once each on the card against the
    CPU: indices equal (an ellipsoid-query row apart must have a point
    within 1e-4 of a surface, in float64)."""
    import torch

    from pdanet_tpu_torch.ops import ball_query, nms, sampling
    from pdanet_tpu_torch.ops.ellipsoid_query import ellipsoid_query

    t0 = time.perf_counter()
    pts = lidar_like_cloud(2110, 2, N_POINTS)[..., :3].copy()
    pts[0, :5, 1] = 0.0
    pts[0, 5:7, :2] = 0.0
    xyz = torch.from_numpy(pts)
    got = sampling.ry_fps(xyz.to(dev), 4096).cpu()
    require(torch.equal(got, sampling.ry_fps(xyz, 4096)), "ry_fps differs card vs CPU")
    sup, ctr = xyz[:1, :4096].contiguous(), xyz[:1, :4096:16].contiguous()
    rows = (ellipsoid_query(0.8, 32, sup.to(dev), ctr.to(dev)).cpu()
            != ellipsoid_query(0.8, 32, sup, ctr)).any(-1)[0]
    if rows.any():
        near = ellipsoid_margin(sup[0], ctr[0], 0.8, 32)[rows]
        require(bool((near < 1e-4).all()), f"the ellipsoid query differs card vs CPU on "
                f"{int(rows.sum())} of {ctr.shape[1]} centres, margins {near.tolist()}")
    dil = ball_query.ball_query_dilated(1.6, 0.8, 32, xyz.to(dev), xyz[:, ::16].to(dev)).cpu()
    require(torch.equal(dil, ball_query.ball_query_dilated(1.6, 0.8, 32, xyz, xyz[:, ::16])),
            "ball_query_dilated differs card vs CPU")
    boxes = torch.from_numpy(random_boxes(2111, 1, 1024)[0])
    scores = torch.from_numpy(np.random.RandomState(2112).rand(1024).astype(np.float32))
    outs = [nms.nms_rotated(boxes.to(d), scores.to(d), 0.1, pre_maxsize=1024, post_maxsize=256)
            for d in (dev, torch.device("cpu"))]
    require(torch.equal(outs[0][0].cpu(), outs[1][0]) and int(outs[0][1]) == int(outs[1][1]),
            "nms_rotated's selection differs card vs CPU")
    print(f"ry_fps B=2 16384 -> 4096 (5 points on y = 0, 2 at x = y = 0), the ellipsoid query "
          f"(4096 points, {ctr.shape[1]} centres, r 0.8, K 32; {int(rows.sum())} rows apart, "
          f"each at a surface), the dilated query (B=2, 1024 centres, 0.8-1.6 m, K 32) and "
          f"nms_rotated (K 1024, {int(outs[0][1])} kept): card equal to the CPU "
          f"({time.perf_counter() - t0:.1f} s)")


class RecordFFPS:
    """Records the rows and picks of the backbone's F-FPS calls."""

    def __enter__(self):
        from pdanet_tpu_torch.models.backbones_3d import iassd_backbone

        self.module, self.own = iassd_backbone, iassd_backbone.farthest_point_sample_features
        self.calls = []

        def run(rows, npoint):
            idx = self.own(rows, npoint)
            self.calls.append((rows.detach().float().contiguous(), npoint, idx))
            return idx

        iassd_backbone.farthest_point_sample_features = run
        return self

    def __exit__(self, *exc):
        self.module.farthest_point_sample_features = self.own


def replay_card_picks(queue, checks):
    """A sampling function for the CPU run that replays the card's picks
    (``queue``, in call order) and notes, per layer, how many of the
    CPU's own picks differ: D-FPS and the sector FPS run on the raw
    coordinates and must agree; F-FPS (FS's first half) and the ctr-aware
    top-k run on computed features, which round apart on the two devices."""
    from pdanet_tpu_torch.models.backbones_3d import iassd_backbone

    own_sampling = iassd_backbone.run_sampling

    def pick(types, ranges, npoints, xyz, features, cls_features):
        own = own_sampling(types, ranges, npoints, xyz, features, cls_features)
        card = queue.pop(0)
        kind = "/".join(types)
        if kind == "FS":  # the F-FPS half, then the D-FPS half
            half = own.shape[1] // 2
            checks.append(("F-FPS (FS)", int((own[:, :half] != card[:, :half]).sum())))
            checks.append(("D-FPS (FS)", int((own[:, half:] != card[:, half:]).sum())))
        else:
            checks.append((kind, int((own != card).sum())))
        return card

    return pick


def iassd_card_vs_cpu(name, cfg, mcfg, model, weights, B, pts, out, post):
    """One float32 request of a variant on the card against the CPU, the
    CPU fed the card's picks: the CPU's own D-FPS / sector FPS picks equal,
    the ball-query indices equal, centre features within 1e-3, cls, box
    and IoU logits within 2e-3, equal detection counts."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.detectors import get_post_processor

    cpu_model = build_network(mcfg, len(cfg.CLASS_NAMES), device="cpu").eval()
    cpu_model.load_state_dict(weights)
    flags = model.backbone_3d.fps_identity
    queue = [s.cpu() for s, f in zip(out["sampled_idx"], flags) if s is not None and not f]
    checks = []
    t0 = time.perf_counter()
    with fed(sampling=replay_card_picks(queue, checks)), torch.inference_mode():
        c_out = cpu_model(pts)
        c_post = get_post_processor(mcfg.NAME)(c_out, mcfg)
    for kind, n in checks:
        if kind in ("D-FPS", "ds_FPS", "ry_FPS", "D-FPS (FS)"):
            require(n == 0, f"{name} b{B}: the CPU's {kind} picks differ from the card's ({n})")
    for k in range(len(c_out["ball_query_idx"])):
        for r, (gb, cb) in enumerate(zip(out["ball_query_idx"][k] or (),
                                         c_out["ball_query_idx"][k] or ())):
            require(torch.equal(gb.cpu(), cb), f"{name} b{B} SA{k} radius {r} ball query "
                    f"differs card vs CPU")
    errs = {key: (out[key].float().cpu() - c_out[key]).abs().max().item()
            for key in ("centers_features", "batch_cls_preds", "center_box_preds",
                        "box_iou3d_preds")}
    print(f"{name} b{B} float32 card vs CPU ({time.perf_counter() - t0:.1f} s on the CPU, the "
          f"card's picks fed; the CPU's own picks apart: {checks}): ball query equal; "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; detections {post['pred_counts'].tolist()} vs {c_post['pred_counts'].tolist()}")
    require(errs["centers_features"] <= 1e-3, f"{name} b{B} centre features {errs}")
    require(max(errs[k] for k in ("batch_cls_preds", "center_box_preds",
                                  "box_iou3d_preds")) <= 2e-3, f"{name} b{B} logits {errs}")
    require(torch.equal(post["pred_counts"].cpu(), c_post["pred_counts"]),
            f"{name} b{B}: detection counts differ card vs CPU")


def iassd_variant(name, dev):
    """One variant of phase 21 at full width, seeded weights, TF32 off:
    the float32 requests of ``IASSD_REQUESTS`` on the card against the
    CPU (``iassd_card_vs_cpu``), the F-FPS kernel's calls held against its
    plain version on their own rows; the shipped bfloat16 closure's b1
    request against the float32 card detections (a report); for V1, the
    b1 program of the bfloat16 closure through ``serving.export_serving``,
    bit-equal to the eager closure; one float32 train step at B = 2
    (finite loss and gradients, ``iou3d_loss_reg`` present).  Returns the
    launches of its requests, program and step, counted from 0."""
    import torch

    from pdanet_tpu_torch.config import cfg_from_list
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.models.detectors import get_post_processor
    from pdanet_tpu_torch.ops import sampling
    from pdanet_tpu_torch.serving import export_serving, make_predict_fn

    t_all = time.perf_counter()
    cfg = cfg_from_list(list(IASSD_VARIANTS[name]), load_config())
    mcfg = _f32_model_cfg(cfg)
    model = init_random_weights(build_network(mcfg, len(cfg.CLASS_NAMES), device=dev),
                                seed=21).eval()
    weights = copy.deepcopy(model.state_dict())
    runs, f32_first = [], None
    for B in IASSD_REQUESTS[name]:
        pts = torch.from_numpy(lidar_like_cloud(2120 + B, B, N_POINTS))
        with torch.inference_mode():  # warm-up
            model(pts.to(dev))
        torch.cuda.synchronize()
        clear_launches()
        with RecordFFPS() as rec, torch.inference_mode():
            t0 = time.perf_counter()
            out = model(pts.to(dev))
            post = get_post_processor(mcfg.NAME)(out, mcfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        runs.append(counted_launches())
        for rows, m, idx in rec.calls:
            require(torch.equal(idx, sampling.farthest_point_sample_features_plain(rows, m)),
                    f"{name} b{B}: F-FPS on SA1's rows differs from the plain version")
        print(f"{name} b{B} float32 request: {ms:.2f} ms (after one warm-up), detections "
              f"{post['pred_counts'].tolist()}; F-FPS calls "
              f"{[tuple(r.shape) + (m,) for r, m, _ in rec.calls]} equal to the plain version "
              f"on the card's rows; launches {runs[-1]}")
        iassd_card_vs_cpu(name, cfg, mcfg, model, weights, B, pts, out, post)
        if B == 1:
            f32_first = (pts, post)

    bf16 = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev)
    bf16.load_state_dict(weights)
    predict = make_predict_fn(bf16, cfg.MODEL)
    b1 = {"points": f32_first[0].to(dev)}
    predict(b1)  # warm-up
    torch.cuda.synchronize()
    clear_launches()
    res = predict(b1)
    torch.cuda.synchronize()
    runs.append(counted_launches())
    pairs, n_bf, n_f32, gap_c, gap_s = match_detections(res, f32_first[1])
    lat, enq = request_ms(predict, b1, reps=5, warmup=1)
    print(f"{name} bfloat16 b1 request (report, no gate): {lat:.2f} ms (enqueue {enq:.2f}); "
          f"{n_bf} and {n_f32} detections against float32, {pairs} paired, largest centre "
          f"distance {gap_c:.4g} m, score difference {gap_s:.4g}")
    if name == "V1":
        t0 = time.perf_counter()
        prog = export_serving(bf16, cfg.MODEL, b1).module()
        export_s = time.perf_counter() - t0
        want = predict(b1)
        clear_launches()
        got = prog(dict(b1))
        torch.cuda.synchronize()
        runs.append(counted_launches())
        for key in want:
            require(torch.equal(got[key], want[key]), f"{name} program: {key} differs from "
                    f"the eager closure")
        print(f"{name} b1 program: exported in {export_s:.1f} s, bit-equal to the eager "
              f"closure; launches {runs[-1]}")
        del prog
    del bf16, predict

    mean_size = np.asarray(cfg.MODEL.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size,
                           np.float32)
    tpts, tgt = lidar_like_batch(2130, 2, N_POINTS, mean_size)
    batch = {"points": torch.from_numpy(tpts).to(dev), "gt_boxes": torch.from_numpy(tgt).to(dev)}
    tmodel, step = _train_model(cfg, mcfg, weights, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    clear_launches()
    t0 = time.perf_counter()
    loss, tb = step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    runs.append(counted_launches())
    require(np.isfinite(loss.item()) and _grads_finite(tmodel), f"{name} step: not finite")
    require("iou3d_loss_reg" in tb and np.isfinite(float(tb["iou3d_loss_reg"])),
            f"{name} step: iou3d_loss_reg {tb.get('iou3d_loss_reg')}")
    print(f"{name} train float32 B=2: loss {loss.item():.4f}, iou3d_loss_reg "
          f"{float(tb['iou3d_loss_reg']):.4f}, center_pos_num {float(tb['center_pos_num']):.0f}; "
          f"{step_ms:.2f} ms (its first step), peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB; launches {runs[-1]}")
    launches = add_launches(*runs)
    for kname in IASSD_KERNELS[name]:
        require(launches.get(kname, 0) > 0, f"kernel {kname} never launched on {name}'s path")
    print(f"phase 21 {name}: {time.perf_counter() - t_all:.1f} s")
    return launches


def iassd_phase(dev):
    """Phase 21: the rest of the IASSD surface.  The F-FPS kernel against
    its plain version (``check_ffps``), the attention at no_global's head
    widths (``check_no_global_attention``), V1 and V2 of
    ``IASSD_VARIANTS`` (``iassd_variant``) and the stand-alone ops
    (``check_iassd_ops``).  Returns the launches of V1's and V2's runs and
    F-FPS's row."""
    ffps = check_ffps(dev)
    check_no_global_attention(dev)
    runs = {name: iassd_variant(name, dev) for name in IASSD_VARIANTS}
    check_iassd_ops(dev)
    return runs, ffps



# ---------------------------------------------------------------------------
# phase 22: the reference checkpoint surface and the profiler CLI


CONVERT_JOBS = (("PDA-SSD", KITTI_CFG_REL, False), ("Voxel-RCNN", VRCNN_CFG_REL, True))
CONVERT_SEED = 22
REFERENCE_WRAPPER = {"epoch": 80, "it": 74240, "version": "pcdet+0.5.2"}  # 80 x 928 steps
CONVERT_TOL = 1e-5  # the converted model's request against the seeded one's
PROFILE_KERNELS = ("fps", "ball_query", "neighbor_attention", "rotated_iou", "nms")


def _ref_linear(sd, key, p, conv_dim=2):
    """A flax Dense as the reference's Linear (``conv_dim`` 2) or 1 x 1
    Conv1d (3) / Conv2d (4)."""
    w = np.asarray(p["kernel"]).T
    sd[f"{key}.weight"] = w.reshape(w.shape + (1,) * (conv_dim - 2))
    if "bias" in p:
        sd[f"{key}.bias"] = np.asarray(p["bias"])


def _ref_conv2d(sd, key, p, transposed=False):
    """A flax Conv (kh, kw, in, out) as Conv2d (out, in, kh, kw); a
    ConvTranspose as ConvTranspose2d (in, out, kh, kw), its taps mirrored
    (the converter's ``_deconv2d_kernel`` mirrors them back)."""
    k = np.asarray(p["kernel"])
    w = k[::-1, ::-1].transpose(2, 3, 0, 1) if transposed else k.transpose(3, 2, 0, 1)
    sd[f"{key}.weight"] = np.ascontiguousarray(w)
    if "bias" in p:
        sd[f"{key}.bias"] = np.asarray(p["bias"])


def _ref_bn(sd, key, p, s):
    sd[f"{key}.weight"], sd[f"{key}.bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])
    sd[f"{key}.running_mean"] = np.asarray(s["mean"])
    sd[f"{key}.running_var"] = np.asarray(s["var"])


def _ref_stack(sd, prefix, params, stats, conv_dim):
    """An MLPStack (``layer{j}``: Dense, BatchNorm) as the reference's
    [Conv, BN, ReLU] x n Sequential."""
    for name, lp in params.items():
        j = int(name[len("layer"):])
        _ref_linear(sd, f"{prefix}.{3 * j}", lp["dense"], conv_dim)
        _ref_bn(sd, f"{prefix}.{3 * j + 1}", lp["bn"], stats[name]["bn"])


def _ref_fc_bn(sd, prefix, params, stats, flax_prefix, n, drop_after):
    """Flat ``{flax_prefix}_fc{k}`` / ``_bn{k}`` as a [Linear, BN, ReLU (,
    Dropout)] x n Sequential; returns the slot after it."""
    idx = 0
    for k in range(n):
        _ref_linear(sd, f"{prefix}.{idx}", params[f"{flax_prefix}_fc{k}"])
        _ref_bn(sd, f"{prefix}.{idx + 1}", params[f"{flax_prefix}_bn{k}"],
                stats[f"{flax_prefix}_bn{k}"])
        idx += 3 + (1 if drop_after(k) else 0)
    return idx


def _ref_transformer(sd, prefix, p):
    """The pre-norm layer as the reference's, its attention an
    ``nn.MultiheadAttention`` (in_proj (3 D, D))."""
    d = np.asarray(p["norm1"]["scale"]).shape[0]
    attn = p["self_attn"]
    qkv = ("query", "key", "value")
    sd[f"{prefix}.self_attn.in_proj_weight"] = np.concatenate(
        [np.asarray(attn[n]["kernel"]).reshape(d, d).T for n in qkv])
    sd[f"{prefix}.self_attn.in_proj_bias"] = np.concatenate(
        [np.asarray(attn[n]["bias"]).reshape(d) for n in qkv])
    sd[f"{prefix}.self_attn.out_proj.weight"] = np.asarray(attn["out"]["kernel"]).reshape(d, d).T
    sd[f"{prefix}.self_attn.out_proj.bias"] = np.asarray(attn["out"]["bias"])
    for name in ("norm1", "norm2"):
        sd[f"{prefix}.{name}.weight"] = np.asarray(p[name]["scale"])
        sd[f"{prefix}.{name}.bias"] = np.asarray(p[name]["bias"])
    for name in ("linear1", "linear2"):
        _ref_linear(sd, f"{prefix}.{name}", p[name])


# flax submodule of an IASSD SA layer -> (the reference's attribute, conv dim)
IASSD_STACKS = {"mlps": ("mlps", 4), "position_mlp": ("position_mlp", 4),
                "global_mlps": ("global_mlps", 4), "fin_conv": ("fin_conv", 4),
                "aggregation_layer": ("aggregation_layer", 3),
                "confidence_mlp": ("confidence_layers", 3), "mlp_modules": ("mlp_modules", 3)}


def _ref_iassd(sd, params, stats, mcfg):
    for mod, mp in params["backbone_3d"].items():
        tp = f"backbone_3d.SA_modules.{int(mod[len('SA_modules_'):])}"
        ms = stats["backbone_3d"].get(mod, {})
        for sub, sp in mp.items():
            stem, _, i = sub.rpartition("_")
            if not i.isdigit():
                stem, i = sub, None
            if stem in IASSD_STACKS:
                attr, conv_dim = IASSD_STACKS[stem]
                _ref_stack(sd, f"{tp}.{attr}" + (f".{i}" if i else ""), sp, ms[sub], conv_dim)
            elif stem == "point_density":
                for j in range(3):
                    base = f"{tp}.point_density.{i}.densitynet"
                    _ref_linear(sd, f"{base}.mlp_convs.{j}", sp[f"conv{j}"], 4)
                    _ref_bn(sd, f"{base}.mlp_bns.{j}", sp[f"bn{j}"], ms[sub][f"bn{j}"])
            elif stem == "Local_pointformer":
                _ref_transformer(sd, f"{tp}.Local_pointformer.{i}", sp)
            elif sub == "confidence_out":
                n = len(mp["confidence_mlp"])
                _ref_linear(sd, f"{tp}.confidence_layers.{3 * n}", sp, 3)
            elif sub == "ctr_reg":
                _ref_linear(sd, f"{tp}.ctr_reg", sp, 3)
            else:
                raise KeyError(f"no reference name for backbone_3d/{mod}/{sub}")
    hp, hs = params["point_head"], stats["point_head"]
    for stack, out, fc in (("cls_center_layers", "cls_center_out", "CLS_FC"),
                           ("box_center_layers", "box_center_out", "REG_FC")):
        _ref_stack(sd, f"point_head.{stack}", hp[stack], hs[stack], 2)
        _ref_linear(sd, f"point_head.{stack}.{3 * len(mcfg.POINT_HEAD[fc])}", hp[out])


def _ref_spconv(w):
    """A sparse conv's (K, in, out) taps as spconv 1.x's (kz, ky, kx, in, out)."""
    w = np.asarray(w)
    return w.reshape({27: (3, 3, 3), 3: (3, 1, 1)}[w.shape[0]] + w.shape[1:])


def _ref_voxel_rcnn(sd, params, stats, mcfg):
    bp, bs = params["backbone_3d"], stats["backbone_3d"]

    def block(name, tp):  # SubM conv, BN
        sd[f"{tp}.0.weight"] = _ref_spconv(bp[name]["kernel"])
        _ref_bn(sd, f"{tp}.1", bp[name]["bn"], bs[name]["bn"])

    def down(name, tp):  # strided sparse conv, BN
        sd[f"{tp}.0.weight"] = _ref_spconv(bp[f"{name}_kernel"])
        _ref_bn(sd, f"{tp}.1", bp[f"{name}_bn"], bs[f"{name}_bn"])

    block("conv_input", "backbone_3d.conv_input")
    block("conv1", "backbone_3d.conv1.0")
    for lvl in (2, 3, 4):
        down(f"conv{lvl}_down", f"backbone_3d.conv{lvl}.0")
        block(f"conv{lvl}_a", f"backbone_3d.conv{lvl}.1")
        block(f"conv{lvl}_b", f"backbone_3d.conv{lvl}.2")
    down("conv_out", "backbone_3d.conv_out")
    p2, s2 = params["backbone_2d"], stats["backbone_2d"]
    for idx in range(len(mcfg.BACKBONE_2D.LAYER_NUMS)):
        _ref_conv2d(sd, f"backbone_2d.blocks.{idx}.1", p2[f"blocks_{idx}_down"]["conv"])
        _ref_bn(sd, f"backbone_2d.blocks.{idx}.2", p2[f"blocks_{idx}_down"]["bn"],
                s2[f"blocks_{idx}_down"]["bn"])
        for k in range(mcfg.BACKBONE_2D.LAYER_NUMS[idx]):
            _ref_conv2d(sd, f"backbone_2d.blocks.{idx}.{4 + 3 * k}", p2[f"blocks_{idx}_{k}"]["conv"])
            _ref_bn(sd, f"backbone_2d.blocks.{idx}.{5 + 3 * k}", p2[f"blocks_{idx}_{k}"]["bn"],
                    s2[f"blocks_{idx}_{k}"]["bn"])
        _ref_conv2d(sd, f"backbone_2d.deblocks.{idx}.0", p2[f"deblocks_{idx}_deconv"],
                    transposed=True)
        _ref_bn(sd, f"backbone_2d.deblocks.{idx}.1", p2[f"deblocks_{idx}_bn"],
                s2[f"deblocks_{idx}_bn"])
    for name, p in params["dense_head"].items():
        _ref_conv2d(sd, f"dense_head.{name}", p)
    rp, rs, roi = params["roi_head"], stats["roi_head"], mcfg.ROI_HEAD
    for k, src in enumerate(roi.ROI_GRID_POOL.FEATURES_SOURCE):
        base = f"roi_head.roi_grid_pool_layers.{k}"
        for tname, fname in (("mlps_in", "in"), ("mlps_pos", "pos"), ("mlps_out", "out")):
            _ref_linear(sd, f"{base}.{tname}.0.0", rp[f"pool_{src}"][f"mlp_{fname}"], 3)
            _ref_bn(sd, f"{base}.{tname}.0.1", rp[f"pool_{src}"][f"bn_{fname}"],
                    rs[f"pool_{src}"][f"bn_{fname}"])
    dp = float(roi.DP_RATIO)
    for torch_name, prefix, fcs in (("shared_fc_layer", "shared", roi.SHARED_FC),
                                    ("cls_fc_layers", "cls", roi.CLS_FC),
                                    ("reg_fc_layers", "reg", roi.REG_FC)):
        n = len(fcs)
        _ref_fc_bn(sd, f"roi_head.{torch_name}", rp, rs, prefix, n,
                   lambda k, n=n: k != n - 1 and dp > 0)
    _ref_linear(sd, "roi_head.cls_pred_layer", rp["cls_pred"])
    _ref_linear(sd, "roi_head.reg_pred_layer", rp["reg_pred"])


def reference_state_dict(variables, mcfg):
    """The reference's ``state_dict`` (names, layouts; numpy) of a flax
    variable tree of PDA-SSD (IASSD) or Voxel-RCNN over the sparse
    backbone: the inverse of the converter
    (``pdanet_tpu_torch/tools/ckpt_converter.py``), written without JAX."""
    emit = {"IASSD": _ref_iassd, "VoxelRCNN": _ref_voxel_rcnn}[mcfg.NAME]
    sd = {}
    emit(sd, variables["params"], variables["batch_stats"], mcfg)
    return sd


def write_reference_pth(path, sd, legacy=False):
    """``sd`` saved in OpenPCDet's wrapper (``epoch``, ``it``,
    ``model_state``, ``optimizer_state``, ``version``), with the keys no
    converter reads: each BatchNorm's ``num_batches_tracked`` and the
    detector's ``global_step``; in torch's zip format or, with ``legacy``,
    the format before it."""
    import torch

    it = REFERENCE_WRAPPER["it"]
    state = {}
    for key, arr in sd.items():
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if key.endswith(".running_var"):
            state[key[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(it)
    state["global_step"] = torch.tensor([it])
    opt = {"state": {}, "param_groups": [{"lr": 0.01, "betas": (0.95, 0.99), "weight_decay": 0.01,
                                          "params": list(range(len(sd)))}]}
    torch.save({**REFERENCE_WRAPPER, "model_state": state, "optimizer_state": opt}, path,
               _use_new_zipfile_serialization=not legacy)
    return len(state)


def _detections_gap(a, b):
    """(equal counts and labels, the largest |difference| of boxes and
    scores, bit-equal) of two prediction dicts."""
    import torch

    same = all(torch.equal(a[k], b[k]) for k in ("pred_counts", "pred_labels"))
    gap = max(float((a[k].float() - b[k].float()).abs().max()) if a[k].numel() else 0.0
              for k in ("pred_boxes", "pred_scores"))
    return same, gap, all(torch.equal(a[k], b[k]) for k in a)


def converted_test_cli_chain(work, kitti_run, ckpt):
    """Phase 22 (a) as a tail chain: ``python -m pdanet_tpu_torch.tools.test
    --ckpt <converted PDA-SSD>`` over phase 9's root at B = 1 (bfloat16 as
    shipped); every val frame in ``result.pkl``, finite; the process's
    launches from its log."""
    def run():
        out_dir = Path(work) / "output" / Path(KITTI_CFG_REL).parent.name / Path(
            KITTI_CFG_REL).stem / "converted"
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "pdanet_tpu_torch.tools.test", "--cfg_file", KITTI_CFG_REL,
             "--ckpt", str(ckpt), "--batch_size", "1", "--extra_tag", "converted",
             "--set", "DATA_CONFIG.DATA_PATH", str(kitti_run["root"])],
            cwd=work, env=tail_env({**os.environ, "PYTHONPATH": str(ROOT)}),
            capture_output=True, text=True, timeout=600)
        require(res.returncode == 0, f"the test CLI on the converted checkpoint failed:\n"
                f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        res_dir = next(out_dir.glob("eval/epoch_*/val/default"))
        _, counts = cli_log(res_dir, "eval")
        with open(res_dir / "result.pkl", "rb") as f:
            annos = pickle.load(f)
        require([a["frame_id"] for a in annos] == kitti_run["val_ids"],
                 "test CLI on the converted checkpoint: frames")
        require(all(np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
                    for a in annos), "test CLI on the converted checkpoint: not finite")
        print(f"PDA-SSD test CLI --ckpt <converted .pth> over phase 9's root (in the tail): "
              f"{time.perf_counter() - t0:.1f} s, detections per val frame "
              f"{[len(a['score']) for a in annos]}; launches {counts}")
        return counts
    return "checkpoint", run


def checkpoint_phase(dev, work, kitti_run, predict):
    """Phase 22: (a) PDA-SSD (bfloat16 as shipped, float32 for the
    requests) and Voxel-RCNN at full width with seeded weights, through
    ``reference_state_dict`` into reference ``.pth`` files (zip; legacy),
    the converter CLI in fresh processes, the converted ``state_dict``
    bit-equal to the seeded one, a float32 b1 request from each converted
    checkpoint (the test CLI's loader) equal to the seeded model's within
    ``CONVERT_TOL``, counts and labels equal; (b) the profiler CLI's e2e b1
    on PDA-SSD, every kernel of ``PROFILE_KERNELS`` a family of its table,
    its busy time beside phase 4's closure's split.  Returns the requests'
    launches and the tail chain of the test CLI on the converted PDA-SSD."""
    import torch

    from pdanet_tpu_torch.config import cfg_from_yaml_file
    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.serving import make_predict_fn
    from pdanet_tpu_torch.tools import profiler
    from pdanet_tpu_torch.train import load_checkpoint, load_model_state
    from pdanet_tpu_torch.utils.jax_weights import port_variables

    work = Path(work)
    jobs = []
    for label, cfg_rel, legacy in CONVERT_JOBS:
        cfg = cfg_from_yaml_file(str(work / cfg_rel))
        mcfg = _f32_model_cfg(cfg) if cfg.MODEL.NAME == "IASSD" else cfg.MODEL
        template = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                                   training=False, root_path=str(kitti_run["root"]))
        def build(mcfg=mcfg, n=len(cfg.CLASS_NAMES), template=template):
            return build_network(mcfg, n, dataset=template, device=dev).eval()

        model = init_random_weights(build(), seed=CONVERT_SEED)
        if hasattr(model, "roi_head"):
            with torch.no_grad():
                model.dense_head.conv_box.weight.mul_(BOX_CONV_SCALE)
        t0 = time.perf_counter()
        sd = reference_state_dict(port_variables(model), cfg.MODEL)
        stem = work / f"reference_{Path(cfg_rel).stem}"
        n_keys = write_reference_pth(f"{stem}.pth", sd, legacy)
        proc = subprocess.Popen(
            [sys.executable, "-m", "pdanet_tpu_torch.tools.ckpt_converter", "--torch_ckpt",
             f"{stem}.pth", "--cfg_file", cfg_rel, "--output", f"{stem}.converted.pth"],
            cwd=work, env=tail_env({**os.environ, "PYTHONPATH": str(ROOT)}),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        mb = Path(f"{stem}.pth").stat().st_size / 1e6
        print(f"{label}: reference .pth ({'legacy' if legacy else 'zip'} format) of {len(sd)} "
              f"tensors and {n_keys - len(sd)} unread keys, {mb:.1f} MB, in "
              f"{time.perf_counter() - t0:.1f} s; the converter CLI started")
        jobs.append((label, cfg, mcfg, template, build, model, stem, proc, time.perf_counter()))

    # (b) the profiler CLI while the converters run on the host's CPU
    pts = torch.from_numpy(lidar_like_cloud(7, 1, N_POINTS)).to(dev)
    report = profiler.main(["--cfg_file", str(YAML), "--mode", "e2e", "--batch_size", "1",
                            "--repeats", "3", "--top", "8"])
    missing = [k for k in PROFILE_KERNELS if k not in report["families"]]
    require(not missing, f"the profiler's families lack the kernels {missing}")
    split = device_split(lambda: predict({"points": pts}))
    print(f"profiler CLI e2e b1 PDA-SSD: busy {report['busy_ms']:.3f} ms a call, device time "
          f"{report['per_call_ms']:.3f} ms; the port's kernels "
          + ", ".join(f"{k} {report['families'][k]:.3f} ms" for k in PROFILE_KERNELS)
          + (f"; phase 4's closure on the same frame: busy {split[1]:.3f} ms" if split else ""))

    launches = {}
    for label, cfg, mcfg, template, build, model, stem, proc, t0 in jobs:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        require(proc.returncode == 0, f"{label} converter CLI failed:\n{out[-2000:]}\n"
                f"{err[-4000:]}")
        print(f"{label} converter CLI: {time.perf_counter() - t0:.1f} s to its exit")
        ck = load_checkpoint(f"{stem}.converted.pth")
        want = model.state_dict()
        require(ck["optimizer_state"] is None and ck["version"] == "converted+"
                + REFERENCE_WRAPPER["version"] and (ck["epoch"], ck["it"]) == (
                    REFERENCE_WRAPPER["epoch"], REFERENCE_WRAPPER["it"]),
                f"{label} converted wrapper {({k: ck[k] for k in ('epoch', 'it', 'version')})}")
        require(set(ck["model_state"]) == set(want), f"{label} converted keys")
        unequal = [k for k, v in want.items() if not torch.equal(ck["model_state"][k], v.cpu())]
        require(not unequal, f"{label} converted state differs from the seeded: {unequal[:5]}")
        converted = build()
        load_model_state(converted, f"{stem}.converted.pth")
        if label == "PDA-SSD":
            batch = {"points": torch.from_numpy(lidar_like_cloud(300, 1, N_POINTS)).to(dev)}
        else:
            batch, _ = voxel_batch(cfg, voxel_frames(CONVERT_SEED, 1, cfg.CLASS_NAMES), False,
                                   dev, model)
            batch.pop("gt_boxes")
        want_pred = make_predict_fn(model, mcfg)(batch)
        clear_launches()
        got_pred = make_predict_fn(converted, mcfg)(batch)
        torch.cuda.synchronize()
        counts = counted_launches()
        same, gap, bits = _detections_gap(got_pred, want_pred)
        print(f"{label} float32 b1 request from the converted checkpoint against the seeded "
              f"model: {int(got_pred['pred_counts'].sum())} detections, counts and labels "
              f"equal {same}, largest box / score difference {gap:.3g}, bit-equal {bits}; "
              f"launches {counts}")
        require(same and gap <= CONVERT_TOL, f"{label}: the converted model's request differs")
        if label == "PDA-SSD":
            for name in PROFILE_KERNELS:
                require(counts.get(name, 0) > 0, f"kernel {name} never launched by the "
                        "converted PDA-SSD's request")
            chain = converted_test_cli_chain(work, kitti_run, f"{stem}.converted.pth")
        launches = add_launches(launches, counts)
        del model, converted
    return launches, chain


@contextlib.contextmanager
def count_augmentor_changes():
    """Wrap every augmentor of the port's ``DataAugmentor`` but the gt
    sampler: yields (calls, changed, dropped) counters by name, counting
    the frames each ran on, those whose points or boxes it changed, and
    those it dropped boxes of (the loader's threads included)."""
    import collections
    import functools
    import threading

    from pdanet_tpu_torch.datasets.augmentor import data_augmentor as da

    calls, changed, dropped = (collections.Counter() for _ in range(3))
    lock = threading.Lock()
    originals = {name: getattr(da.DataAugmentor, name) for name in da.AUGMENTORS[1:]}

    def wrap(name, orig):
        def method(self, data_dict=None, config=None):
            if data_dict is None:
                return functools.partial(method, self, config=config)
            pts, boxes = data_dict["points"].copy(), data_dict["gt_boxes"].copy()
            out = orig(self, data_dict=data_dict, config=config)
            moved = (pts.shape != out["points"].shape or boxes.shape != out["gt_boxes"].shape
                     or not np.array_equal(pts, out["points"])
                     or not np.array_equal(boxes, out["gt_boxes"]))
            with lock:
                calls[name] += 1
                changed[name] += moved
                dropped[name] += len(out["gt_boxes"]) < len(boxes)
            return out
        return method

    for name, orig in originals.items():
        setattr(da.DataAugmentor, name, wrap(name, orig))
    try:
        yield calls, changed, dropped
    finally:
        for name, orig in originals.items():
            setattr(da.DataAugmentor, name, orig)


def augmentor_phase(dev, work):
    """Phase 16, the zoo's point augmentors: ``AUG_CFG_RELS`` through the
    train CLI for one epoch of a root of their own (``AUG_CLI_SPLITS``, at
    the yaml's B = 4, no evaluation): finite losses, every enabled
    augmentor run on every train frame and the new ones (local rotation
    and scaling, world translation, the pyramid augmentation) changing
    some; then the newaugs yaml's loader alone over the same epoch with
    its DISABLE_AUG_LIST emptied, every one of its augmentors run, the
    frustum dropouts and the local translation changing frames and the
    names and masks staying aligned where the world dropout drops boxes.
    Prints, a yaml and augmentor, on how many frames it changed the points
    or the boxes.  Returns the CLIs' launches."""
    from pdanet_tpu_torch.config import cfg_from_yaml_file
    from pdanet_tpu_torch.datasets import build_dataloader
    from pdanet_tpu_torch.datasets.kitti.kitti_dataset import create_kitti_infos
    from pdanet_tpu_torch.tools import train as train_cli

    work = Path(work)
    cfgs = [cfg_from_yaml_file(str(work / rel)) for rel in AUG_CFG_RELS]
    root = work / "kitti_augs"
    t0 = time.perf_counter()
    counts = write_kitti_root(root, list(KITTI_MEAN_SIZES), list(KITTI_MEAN_SIZES.values()),
                              seed=16, splits=AUG_CLI_SPLITS)
    create_kitti_infos(cfgs[0].DATA_CONFIG, list(cfgs[0].CLASS_NAMES), root, root, workers=4)
    print(f"phase 16 augmentor KITTI root {counts} (frames, boxes, fewest points in the field "
          f"of view) with infos in {time.perf_counter() - t0:.1f} s")
    n_train = dict(AUG_CLI_SPLITS)["train"]
    new = ("random_local_rotation", "random_local_scaling", "random_world_translation",
           "random_local_pyramid_aug")
    launches = []
    for rel, cfg in zip(AUG_CFG_RELS, cfgs):
        aug_cfg = cfg.DATA_CONFIG.DATA_AUGMENTOR
        enabled = [c.NAME for c in aug_cfg.AUG_CONFIG_LIST
                   if c.NAME not in aug_cfg.DISABLE_AUG_LIST and c.NAME != "gt_sampling"]
        B = cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
        clear_launches()
        t0 = time.perf_counter()
        with count_augmentor_changes() as (calls, changed, _), contextlib.chdir(work):
            out = train_cli.main(["--cfg_file", rel, "--epochs", "1", "--batch_size", str(B),
                                  "--num_epochs_to_eval", "0", "--set", "DATA_CONFIG.DATA_PATH",
                                  str(root)])
        out = work / out  # the CLI's output directory, relative to its working directory
        launches.append(counted_launches())
        losses = [json.loads(line)["value"] for line in
                  (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()
                  if json.loads(line)["tag"] == "train/loss"]
        require(len(losses) == n_train // B and all(np.isfinite(losses)),
                f"{Path(rel).stem} train CLI losses {losses}")
        print(f"{Path(rel).stem} train CLI (1 epoch at B={B}, {n_train} frames): "
              f"{time.perf_counter() - t0:.1f} s; losses {[round(x, 4) for x in losses]}; "
              f"frames each augmentor changed (of those it ran on): "
              + ", ".join(f"{n} {changed[n]}/{calls[n]}" for n in enabled)
              + (f"; disabled by the yaml: {list(aug_cfg.DISABLE_AUG_LIST)}"
                 if any(c.NAME in aug_cfg.DISABLE_AUG_LIST for c in aug_cfg.AUG_CONFIG_LIST)
                 else ""))
        for name in enabled:
            require(calls[name] == n_train, f"{Path(rel).stem}: {name} ran on {calls[name]} of "
                    f"{n_train} train frames")
            require(name not in new or changed[name] > 0,
                    f"{Path(rel).stem}: {name} changed no frame")

    # the newaugs yaml's loader with every augmentor it configures
    cfg = copy.deepcopy(cfgs[0])
    cfg.DATA_CONFIG.DATA_PATH = str(root)
    disabled = list(cfg.DATA_CONFIG.DATA_AUGMENTOR.DISABLE_AUG_LIST)
    cfg.DATA_CONFIG.DATA_AUGMENTOR.DISABLE_AUG_LIST = []
    t0 = time.perf_counter()
    with count_augmentor_changes() as (calls, changed, dropped):
        _, loader, _ = build_dataloader(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES),
                                        cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU, workers=4,
                                        training=True)
        batches = list(loader)
    require(len(batches) == n_train // cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU,
            f"newaugs loader: {len(batches)} batches")
    names = [c.NAME for c in cfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST
             if c.NAME != "gt_sampling"]
    print(f"{Path(AUG_CFG_RELS[0]).stem} loader alone with its DISABLE_AUG_LIST {disabled} "
          f"emptied ({time.perf_counter() - t0:.1f} s, {len(batches)} batches): frames each "
          f"augmentor changed (of those it ran on): "
          + ", ".join(f"{n} {changed[n]}/{calls[n]}" for n in names)
          + f"; frames whose boxes the world frustum dropout dropped (their names and masks "
          f"with them): {dropped['random_world_frustum_dropout']}")
    for name in names:
        require(calls[name] == n_train, f"newaugs loader: {name} ran on {calls[name]} of "
                f"{n_train} frames")
    for name in disabled:
        require(changed[name] > 0, f"newaugs loader: {name} changed no frame")
    return add_launches(*launches)


# phase 23: the host library (pdanet_tpu_torch/native), each site against
# its numpy plain version on the card's host
HOST_FRAMES = 5  # 120000-point LiDAR-like frames a site runs on
HOST_VOXEL_CFG_RELS = (PP_CFG_REL, SECOND_CFG_REL)  # the voxelizer's processors
HOST_SAMPLED = {"Car": 20, "Pedestrian": 15, "Cyclist": 15}  # kitti_dataset.yaml's gt sampling
HOST_OVERLAP_TOL = 1e-4  # the overlaps' gate against the plain versions (tests/test_native.py)
HOST_FACE_ULPS = 4  # a mask may differ from the plain version's only this near a face


@contextlib.contextmanager
def recorded_rotate_iou():
    """Records each (boxes, qboxes, criterion) that the KITTI evaluation
    passes ``rotate_iou_eval``, which runs as ever."""
    from pdanet_tpu_torch.datasets.kitti.kitti_object_eval_python import eval as kitti_eval

    calls, orig = [], kitti_eval.rotate_iou_eval

    def record(boxes, qboxes, criterion=-1):
        calls.append((np.array(boxes), np.array(qboxes), criterion))
        return orig(boxes, qboxes, criterion)

    kitti_eval.rotate_iou_eval = record
    try:
        yield calls
    finally:
        kitti_eval.rotate_iou_eval = orig


def host_ms(fn, *args):
    """(milliseconds on the host clock, result) of one call."""
    t0 = time.perf_counter()
    out = fn(*args)
    return (time.perf_counter() - t0) * 1e3, out


def face_ulps(point, box):
    """How near ``point`` lies to a face of ``box`` (x y z dx dy dz heading),
    in ulps of the face's float32 half-extent as the host library computes
    it: the local coordinates in float64, the half-extents in float32."""
    half = np.array([np.float32(box[3]) * np.float32(0.5) + np.float32(1e-5),
                     np.float32(box[4]) * np.float32(0.5) + np.float32(1e-5),
                     np.float32(box[5]) * np.float32(0.5)], np.float32)
    d = np.asarray(point[:3], np.float64) - np.asarray(box[:3], np.float64)
    c, s = np.cos(np.float64(box[6])), np.sin(np.float64(box[6]))
    local = np.abs([d[0] * c + d[1] * s, -d[0] * s + d[1] * c, d[2]])
    return float(np.min(np.abs(half.astype(np.float64) - local) / np.spacing(half)))


def collision_boxes(rs, frame_boxes):
    """The gt sampler's draw at kitti_dataset.yaml's ``SAMPLE_GROUPS``: 50
    database boxes of the three classes at the yaml's mean sizes (10 %
    jitter), each where its own frame held it (in the camera's field of
    view, 5-55 m out, on the ground), so some meet the frame's boxes and
    each other."""
    boxes = []
    for cls, n in HOST_SAMPLED.items():
        dims = np.asarray(KITTI_MEAN_SIZES[cls]) * rs.uniform(0.9, 1.1, (n, 3))
        r, th = rs.uniform(5.0, 55.0, n), rs.uniform(-0.61, 0.61, n)
        boxes.append(np.column_stack([r * np.cos(th), r * np.sin(th), -1.73 + dims[:, 2] / 2,
                                      dims, rs.uniform(-np.pi, np.pi, n)]))
    return np.concatenate(boxes).astype(np.float32), frame_boxes.astype(np.float32)


def host_library_phase(dev, kitti_run):
    """Phase 23: the port's g++ host library (``pdanet_tpu_torch/native``)
    at the four host sites where the JAX package runs its own, each against
    its numpy plain version on the same inputs; any mismatch raises."""
    import torch
    from unittest import mock

    from pdanet_tpu_torch import native
    from pdanet_tpu_torch.config import cfg_from_yaml_file
    from pdanet_tpu_torch.datasets.dataset import DatasetTemplate
    from pdanet_tpu_torch.datasets.kitti.kitti_object_eval_python import rotate_iou
    from pdanet_tpu_torch.datasets.processor import data_processor
    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights
    from pdanet_tpu_torch.serving import make_predict_fn
    from pdanet_tpu_torch.utils import box_utils, iou3d_np

    med = statistics.median
    # ---- (a) the build: a fresh compile beside the library the phases loaded
    compiler = subprocess.run([native.CXX, "--version"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="pdanet_host_") as fresh, \
            mock.patch.object(native, "BUILD_ROOT", Path(fresh)):
        build_s, _ = host_ms(native.build)
    native.lib()
    print(f"host library: {compiler}; a fresh build {build_s / 1e3:.2f} s "
          f"({' '.join(native.CXX_FLAGS)}); loaded {native.build()}")

    rs = np.random.RandomState(23)
    frames = [kitti_like_frame(rs, list(KITTI_MEAN_SIZES), list(KITTI_MEAN_SIZES.values()))
              for _ in range(HOST_FRAMES)]

    # ---- (b) the voxelizer, through the yamls' processors at both budgets
    for cfg_rel in HOST_VOXEL_CFG_RELS:
        cfg = cfg_from_yaml_file(str(ROOT / "tools" / cfg_rel))
        (vox,) = [c for c in cfg.DATA_CONFIG.DATA_PROCESSOR
                  if c.NAME == "transform_points_to_voxels"]
        dp = data_processor.DataProcessor(cfg.DATA_CONFIG.DATA_PROCESSOR,
                                          cfg.DATA_CONFIG.POINT_CLOUD_RANGE, training=False,
                                          num_point_features=4)
        pcr, vsz = dp.point_cloud_range, np.asarray(vox.VOXEL_SIZE, np.float32)
        for split, budget in vox.MAX_NUMBER_OF_VOXELS.items():
            lib_ms, plain_ms, filled = [], [], []
            for pts, _, _ in frames:
                pts = pts[box_utils.mask_points_by_range(pts, pcr)]
                args = (pts, pcr, vsz, dp.grid_size, vox.MAX_POINTS_PER_VOXEL, budget)
                t, got = host_ms(native.voxelize, *args)
                lib_ms.append(t)
                t, want = host_ms(data_processor.voxelize_plain, *args)
                plain_ms.append(t)
                for g, w, what in zip(got, want, ("voxels", "coords", "num_points")):
                    require(g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w),
                            f"{cfg_rel} {split}: the library's {what} differ from the plain "
                            f"version's")
                filled.append(len(got[0]))
            # the hash alone: the library into buffers whose pages are already
            # mapped (the wrapper's fresh budget takes its page faults)
            warm = [np.ones((budget, vox.MAX_POINTS_PER_VOXEL, 4), np.float32),
                    np.ones((budget, 3), np.int32), np.ones(budget, np.int32)]
            hash_ms = [host_ms(native.lib().voxelize_f32, pts, len(pts), 4, pcr, vsz,
                               dp.grid_size, vox.MAX_POINTS_PER_VOXEL, budget, *warm)[0]
                       for _ in range(3)]
            print(f"  (b) voxelizer, {Path(cfg_rel).stem} ({list(vox.VOXEL_SIZE)} m, "
                  f"{vox.MAX_POINTS_PER_VOXEL} points, {split} budget {budget}): voxels "
                  f"{filled}, equal to the plain version; host ms a frame, library "
                  f"{[round(t, 2) for t in lib_ms]} (median {med(lib_ms):.2f}; the hash alone "
                  f"into mapped buffers {med(hash_ms):.2f}), plain "
                  f"{[round(t, 2) for t in plain_ms]} (median {med(plain_ms):.2f})")

    # ---- (c) points in boxes: each frame's points in its gt boxes
    lib_ms, plain_ms, flips = [], [], []
    for pts, boxes, _ in frames:
        boxes = boxes.astype(np.float32)
        t, got = host_ms(box_utils.points_in_boxes_cpu, pts[:, :3], boxes)
        lib_ms.append(t)
        t, want = host_ms(box_utils.points_in_boxes_plain, pts[:, :3], boxes)
        plain_ms.append(t)
        require(got.dtype == want.dtype == np.int32 and got.shape == want.shape,
                "points_in_boxes_cpu: dtype or shape")
        for b, p in zip(*np.nonzero(got != want)):
            ulps = face_ulps(pts[p], boxes[b])
            print(f"  (c) mask flip: point {pts[p, :3].tolist()} in box {boxes[b].tolist()}: "
                  f"library {got[b, p]}, plain {want[b, p]}, {ulps:.2f} ulps from a face")
            require(ulps <= HOST_FACE_ULPS, f"points_in_boxes_cpu differs from the plain "
                    f"version {ulps:.2f} ulps from a face (> {HOST_FACE_ULPS})")
            flips.append(ulps)
    print(f"  (c) points_in_boxes_cpu, {pts.shape[0]} points x "
          f"{[len(f[1]) for f in frames]} boxes: {len(flips)} points flipped against the plain "
          f"version (all within {HOST_FACE_ULPS} ulps of a face); host ms, library "
          f"{[round(t, 2) for t in lib_ms]} (median {med(lib_ms):.2f}), plain "
          f"{[round(t, 2) for t in plain_ms]} (median {med(plain_ms):.2f})")

    # ---- (d) the gt sampler's collision test
    lib_ms, plain_ms, gap, met = [], [], 0.0, 0
    for _, boxes, _ in frames:
        sampled, existed = collision_boxes(rs, boxes)
        pairs = ((sampled, existed), (sampled, sampled))
        t, got = host_ms(lambda: [iou3d_np.boxes_bev_iou_cpu(a, b) for a, b in pairs])
        lib_ms.append(t)
        with mock.patch.object(iou3d_np, "boxes_bev_overlap_cpu",
                               iou3d_np.boxes_bev_overlap_plain):
            t, want = host_ms(lambda: [iou3d_np.boxes_bev_iou_cpu(a, b) for a, b in pairs])
        plain_ms.append(t)
        for g, w in zip(got, want):
            require(g.dtype == w.dtype == np.float32 and g.shape == w.shape,
                    "boxes_bev_iou_cpu: dtype or shape")
            gap = max(gap, float(np.abs(g - w).max()))
            met += int((g > 0).sum())
    require(gap <= HOST_OVERLAP_TOL, f"the collision test's IoU {gap} from the plain version's")
    print(f"  (d) gt sampler collision test, {len(sampled)} sampled boxes against each frame's "
          f"{[len(f[1]) for f in frames]} and against each other: {met} pairs meet, largest "
          f"IoU gap to the plain version {gap:.3g}; host ms a frame, library "
          f"{[round(t, 3) for t in lib_ms]} (median {med(lib_ms):.3f}), plain "
          f"{[round(t, 2) for t in plain_ms]} (median {med(plain_ms):.2f})")

    # ---- (e) the evaluation's rotated IoU at the shapes phase 9's evaluation passed it
    calls = kitti_run["eval_iou_calls"]
    require(calls, "phase 9's evaluation passed rotate_iou_eval nothing")
    lib_ms, plain_ms, gap = [], [], 0.0
    for boxes, qboxes, _ in calls:
        t, got = host_ms(lambda: [rotate_iou.rotate_iou_eval(boxes, qboxes, c)
                                  for c in (-1, 0, 1, 2)])
        lib_ms.append(t)
        with mock.patch.object(rotate_iou, "rotate_overlap", rotate_iou.rotate_overlap_plain):
            t, want = host_ms(lambda: [rotate_iou.rotate_iou_eval(boxes, qboxes, c)
                                       for c in (-1, 0, 1, 2)])
        plain_ms.append(t)
        for g, w in zip(got, want):
            require(g.dtype == w.dtype and g.shape == w.shape, "rotate_iou_eval: dtype or shape")
            gap = max(gap, float(np.abs(g - w).max()))
    require(gap <= HOST_OVERLAP_TOL, f"rotate_iou_eval {gap} from the plain version's")
    print(f"  (e) rotate_iou_eval, criteria -1, 0, 1 and 2 at phase 9's shapes "
          f"{[(len(b), len(q), c) for b, q, c in calls]} (rows, columns, criterion there): "
          f"largest gap to the plain version {gap:.3g}; host ms for the four, library "
          f"{[round(t, 2) for t in lib_ms]}, plain {[round(t, 2) for t in plain_ms]}")

    # ---- (f) PointPillar b1, points to detections: the host processors, the
    # collate and the request, with the library's voxelizer and the plain one
    cfg = cfg_from_yaml_file(str(ROOT / "tools" / PP_CFG_REL))
    template = DatasetTemplate(dataset_cfg=cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                               training=False, root_path=str(kitti_run["root"]))
    model = init_random_weights(build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset=template,
                                              device=dev), seed=0)
    predict = make_predict_fn(model, cfg.MODEL)
    pp_frames = voxel_frames(123, HOST_FRAMES, cfg.CLASS_NAMES)

    def points_to_detections(frame, plain):
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(mock.patch.object(data_processor.native, "voxelize",
                                                      data_processor.voxelize_plain))
            t0 = time.perf_counter()
            batch, _ = voxel_batch(cfg, [frame], False, dev, model)
            batch.pop("gt_boxes")  # a request carries the voxels alone
            res = predict(batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, res

    for plain in (False, True):  # warm-up
        points_to_detections(pp_frames[0], plain)
    clear_launches()
    ms = {False: [], True: []}
    for frame in pp_frames:  # in turns: library, plain, plain, library
        outs = {}
        for plain in (False, True, True, False):
            t, outs[plain] = points_to_detections(frame, plain)
            ms[plain].append(t)
        for k, v in outs[False].items():
            require(torch.equal(v, outs[True][k]), f"PointPillar's {k} differ with the plain "
                    f"voxelizer")
    counts = counted_launches()
    for name in ("rotated_iou", "nms"):
        require(counts.get(name, 0) > 0, f"kernel {name} never launched in (f)")
    print(f"  (f) PointPillar b1, points to detections ({KITTI_FRAME_POINTS} points, float32; "
          f"the processors, the collate, the request; detections equal): library voxelizer "
          f"{[round(t, 2) for t in ms[False]]} ms (median {med(ms[False]):.2f}), plain "
          f"{[round(t, 2) for t in ms[True]]} ms (median {med(ms[True]):.2f}); launches "
          f"{ {k: v for k, v in counts.items() if k.startswith(('rotated_iou', 'nms'))} }")
    del predict, model
    torch.cuda.empty_cache()


def ptxas_report(log):
    """(kernel, registers, shared-memory bytes, spill bytes) per kernel of
    an ``nvcc -Xptxas -v`` log, names shortened from their mangled form
    (the tensor-core attention kernels as name<KP,HD>)."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN(\w+)'", line)
        if m:
            rest, parts = m.group(1), []
            while rest[:1].isdigit():  # length-prefixed names: namespace, kernel
                n = re.match(r"\d+", rest).group()
                parts.append(rest[len(n):len(n) + int(n)])
                rest = rest[len(n) + int(n):]
            name = parts[-1] if parts else m.group(1)
            t = re.match(r"I((?:[fd]|Li\d+E)+)E", rest)  # float, double, integers
            if t:
                args = re.findall(r"Li(\d+)E|([fd])", t.group(1))
                name += "<" + ",".join(n or {"f": "float", "d": "double"}[c]
                                       for n, c in args) + ">"
            elif rest.startswith("I"):
                name += "<" + rest[1:2] + ">"
            rows.append([name, 0, 0, 0])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and rows:
            rows[-1][3] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and rows:
            rows[-1][1] = int(m.group(1))
            rows[-1][2] = int(m.group(2) or 0)
    return rows


def load_parent(root):
    """Another tree's ``pdanet_tpu_torch`` models, serving closure and FPS,
    ball-query, attention, IoU and NMS wrappers, imported under another
    package name so that both
    trees run in this process; its kernels build into that tree's own
    ``_build``."""
    import importlib
    import importlib.util

    name = "parent_pdanet_tpu_torch"
    pkg = Path(root).resolve() / "pdanet_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    importlib.import_module(f"{name}.ops.cuda_lib").lib()
    return types.SimpleNamespace(models=importlib.import_module(f"{name}.models"),
                                 serving=importlib.import_module(f"{name}.serving"),
                                 sampling=importlib.import_module(f"{name}.ops.sampling"),
                                 ball_query=importlib.import_module(f"{name}.ops.ball_query"),
                                 attention=importlib.import_module(f"{name}.ops.attention"),
                                 rotated_iou=importlib.import_module(f"{name}.ops.rotated_iou"),
                                 nms=importlib.import_module(f"{name}.ops.nms"))


def multi_gpu(dev, world):
    """``--world``: the device guard on every other GPU, then phase 9 on
    ``dev`` and phase 11 over ``world`` GPUs."""
    import torch

    from pdanet_tpu_torch.models import build_network
    from pdanet_tpu_torch.models.blocks import init_random_weights

    require(torch.cuda.device_count() >= world,
            f"--world {world}: {torch.cuda.device_count()} GPUs")
    for k in range(1, world):
        t0 = time.perf_counter()
        n = check_off_device(torch.device("cuda", k))
        print(f"every kernel on cuda:{k} with cuda:0 current: equal to its plain version "
              f"({n} launches), {time.perf_counter() - t0:.1f} s")
    cfg = load_config()
    weights = init_random_weights(build_network(cfg.MODEL, len(cfg.CLASS_NAMES), device=dev),
                                  seed=0).state_dict()
    with tempfile.TemporaryDirectory(prefix="pdanet_kitti_") as work:
        t0 = time.perf_counter()
        _, kitti_run = kitti_phase(dev, work)
        print(f"phase 9 (KITTI through the CLIs): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp_phase(dev, work, kitti_run, cfg, weights, world)
        print(f"phase 11 (data parallel, {world} GPUs): {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout of the repository whose FPS, "
                    "ball-query, float32 attention, IoU and NMS kernels and eager b1 request "
                    "phases 3, 4 and 6 time in turns beside this tree's, and whose IoU kernel "
                    "phases 12-16 (e) time beside this tree's on their candidates")
    ap.add_argument("--sweep", action="store_true", help="time FPS and the ball query in the "
                    "launch shapes their defaults were chosen from, instead of phases 3-7")
    ap.add_argument("--world", type=int, default=1, help="with more than 1: instead of "
                    "phases 3-16, every kernel on cuda:1 and up while cuda:0 is current, then "
                    "phase 9 and phase 11 over this many GPUs (NCCL, one process a GPU)")
    ap.add_argument("--phases", help="comma-separated phases of 3-23 to run, with those they "
                    "read (3 for 6, 4 for 5, 11 and 22, 9 for 11-20, 22 and 23); every phase "
                    "without it, and only then are the launches of every kernel required")
    args = ap.parse_args()
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port is checked on a GPU only")
    sys.path.insert(0, str(ROOT))
    from pdanet_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    # ---- 1. preconditions
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; host {os.cpu_count()} CPUs, "
          f"{len(os.sched_getaffinity(0))} usable, torch on {torch.get_num_threads()} threads")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build
    t0 = time.perf_counter()
    lib = cuda_lib.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s, {len(cuda_lib.SOURCES)} sources "
          f"in parallel")
    mma, simt = [], []
    for name, regs, smem, spill in ptxas_report(cuda_lib.build_log):
        if name.split("<")[0] in ("attn_kernel", "attn_bwd_kernel"):
            simt.append((name, spill))
        if "_mma<" in name:
            mma.append((name, regs, spill))
            if not any(f"<{kp},{hd}>" in name for kp in (16, 32) for hd in (64, 128)):
                continue
        print(f"  ptxas: {name}: {regs} registers, {smem} bytes static shared memory, "
              f"{spill} bytes spilled")
    if mma:
        print(f"  ptxas: {len(mma)} tensor-core attention instantiations (K 16-64 x hd 16-128): "
              f"at most {max(r for _, r, _ in mma)} registers, "
              f"{sum(s for _, _, s in mma)} bytes spilled in all")
    require(len(simt) == 12 and not any(sp for _, sp in simt),
            f"the float32 / float64 attention instantiations spill or are missing: {simt}")
    post = [(name, spill) for name, _, _, spill in ptxas_report(cuda_lib.build_log)
            if name.split("<")[0] in ("iou_self_kernel", "nms_mask_kernel", "nms_walk_kernel")]
    require(len(post) == 4 and not any(sp for _, sp in post),
            f"the IoU / NMS kernels (two walk instantiations) spill or are missing: {post}")
    for K, hd in ((16, 64), (32, 64), (16, 128), (32, 128), (64, 128)):
        print(f"  bfloat16 attention K={K} hd={hd}: one-warp CTAs resident per SM, forward "
              f"{lib.pdanet_neighbor_attention_bf16_occupancy(K, hd)}, backward "
              f"{lib.pdanet_neighbor_attention_bwd_bf16_occupancy(K, hd)}")

    if args.sweep:
        sweep(dev)
        return
    if args.world > 1:
        multi_gpu(dev, args.world)
        return

    # ---- 3.-23.
    every = set(range(3, 24))
    want = every if not args.phases else {int(p) for p in args.phases.split(",")}
    require(want <= every, f"--phases {args.phases}: phases 3-23 only")
    want |= {3} if 6 in want else set()
    want |= {4} if want & {5, 11, 22} else set()
    want |= {9} if want & (set(range(11, 21)) | {22, 23}) else set()
    parent = None
    if args.parent:
        t0 = time.perf_counter()
        parent = load_parent(args.parent)
        print(f"parent tree {args.parent}: kernel build {time.perf_counter() - t0:.1f} s")
    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        return out

    runs, voxel_runs, stats, cfg = {}, [], None, load_config()
    if 3 in want:
        stats = timed("3 (kernels)", check_kernels, dev, parent)
    if 4 in want:
        runs["served"], weights, predict = timed("4 (serve)", serve, cfg, dev, parent)
    if 5 in want:
        timed("5 (float32 frame)", compare_f32, cfg, weights, dev, predict)
    if 6 in want:
        timed("6 (attention backward)", check_attention_bwd, dev, stats, parent)
    if 7 in want:
        trained = timed("7 (train)", train, cfg, weights, dev)
        runs["train_bf16"], runs["train_f32"] = trained["bf16"], trained["f32"]
        timed("7 (train, card against CPU)", compare_train, cfg, weights, dev)
    if 8 in want:
        with tempfile.TemporaryDirectory(prefix="pdanet_once_") as work:
            runs["once"] = timed("8 (ONCE)", once_phase, dev, work)
    ffps = None
    if 21 in want:
        iassd_runs, ffps = timed("21 (the IASSD surface: F-FPS, FS, the sector FPS, the SA "
                                 "ablations, IOU_FC, the stand-alone ops)", iassd_phase, dev)
        runs.update({f"iassd_{name}": run for name, run in iassd_runs.items()})
    if 9 in want:
        with tempfile.TemporaryDirectory(prefix="pdanet_kitti_") as kitti_work:
            runs["kitti"], kitti_run = timed("9 (KITTI through the CLIs)", kitti_phase, dev,
                                             kitti_work)
            exports, chains = [], []
            if 10 in want:  # its programs' fresh process and the serve CLI run in the tail
                work = Path(kitti_work) / "export"
                work.mkdir()
                runs["exported"], chain = timed("10 (export and serve)", export_phase, dev, work)
                chains.append(chain)
            if 11 in want:  # the ranks' processes and the CLIs run in the tail
                runs["dp"], chain = timed("11 (data parallel)", dp_phase, dev, kitti_work,
                                          kitti_run, cfg, weights)
                chains.append(chain)


            def voxel(key, label, fn):
                phase = int(str(key)[:2])
                if phase in want:
                    run, run_rows, extra, tail = timed(f"{phase} ({label})", fn, dev,
                                                       kitti_work, kitti_run, parent)
                    runs[label] = run
                    voxel_runs.append((phase, VOXEL_SUFFIX[key], run, run_rows, extra))
                    if tail[0] is not None:  # CaDDN's export is refused
                        exports.append(tail[0])
                    if tail[1] is not None:
                        chains.append(tail[1])

            for key, label, fn in ((12, "PointPillar", pointpillar_phase),
                                   (13, "SECOND", second_phase),
                                   (14, "Voxel-RCNN", voxel_rcnn_phase),
                                   ("15a", "SECOND-IoU", second_iou_phase),
                                   ("15b", "SECOND-multihead", multihead_phase),
                                   (16, "CenterPoint", centerpoint_phase)):
                voxel(key, label, fn)
            if 16 in want:
                runs["augmentors"] = timed("16 (the augmentors' yamls)", augmentor_phase, dev,
                                           kitti_work)
            voxel(17, "PV-RCNN", pv_rcnn_phase)
            voxel("17b", "PV-RCNN++", pv_rcnn_pp_phase)
            voxel("18a", "Part-A2", parta2_phase)
            voxel("18b", "Part-A2-free", parta2_free_phase)
            voxel("19a", "PointRCNN", pointrcnn_phase)
            voxel("19b", "PointRCNN-IoU", pointrcnn_iou_phase)
            voxel(20, "CaDDN", caddn_phase)
            if 20 in want:
                for label, suffix, run, run_rows in timed(
                        "20b (the dynamic VFEs, ATSS, the dense-grid pool)", variants_phase, dev,
                        kitti_work, kitti_run, parent):
                    runs[label] = run
                    if suffix:
                        voxel_runs.append(("20b", suffix, run, run_rows, []))
            if 22 in want:
                runs["checkpoint"], chain = timed(
                    "22 (the reference checkpoint converter, the profiler CLI)",
                    checkpoint_phase, dev, kitti_work, kitti_run, predict)
                chains.append(chain)
            if 23 in want:  # on the host before the tail's processes load it
                timed("23 (the host library)", host_library_phase, dev, kitti_run)
            if 11 in want:
                chains.insert(0, ("dp", lambda: dp_cli(kitti_work, kitti_run)))
            if exports or chains:
                tail = timed("11-22 (the tail: dist_train.sh, dist_test.sh, the programs "
                             "exported and reloaded, the test CLI on the converted "
                             "checkpoint)", run_tail, exports, chains)
                for label, counts in tail.items():
                    runs[label].update(add_launches(runs[label], counts))

    # launches: each kernel's count over the KITTI serving run (phase 4),
    # the bfloat16 and float32 train steps (phase 7), the ONCE train steps
    # and eval_one_epoch (phase 8), the KITTI train and test CLIs (phase 9),
    # the exported programs' requests (phase 10) and the data-parallel runs
    # (phase 11: its CLIs' processes, the one process and the two ranks)
    # and the voxel detectors' runs (phases 12-18: the requests, the train
    # steps, the CLIs and the program's request), each counted from 0; a
    # row of phases 12-18 counts its own phase's launches at its own K (a
    # PV-RCNN FPS row the phase's FPS launches, a ball-query row those at
    # its site)
    launches = {name: sum(run.get(name, 0) for run in runs.values()) for name in KERNELS}
    if want == every:
        for name, n in launches.items():
            require(n > 0, f"kernel {name} never launched on the main path")
            require(runs["once"].get(name, 0) > 0, f"kernel {name} never launched on the ONCE "
                    f"path")
    rows = [] if stats is None else [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **stats[name]} for name, (src, rep) in KERNELS.items()]
    for phase, suffix, run, run_rows, extra in voxel_runs:
        for K, k_rows in sorted(run_rows.items(), reverse=True):
            for name in VOXEL_KERNELS:
                n = run.get(f"{name}_k{K}", 0)
                require(n > 0, f"kernel {name} never launched at K {K} in phase {phase}")
                rows.append({"name": f"{name}_k{K}{suffix}", "route": "cuda",
                             "source": KERNELS[name][0], "replaces": KERNELS[name][1],
                             "launches": n, **k_rows[name]})
        for row_name, name, count, numbers in extra:
            # a row's launches: FPS's, or the ball query's at the row's site
            n = run.get(count, 0)
            require(n > 0, f"kernel {name} never launched for {row_name} in phase {phase}")
            rows.append({"name": row_name, "route": "cuda", "source": KERNELS[name][0],
                         "replaces": KERNELS[name][1], "launches": n, **numbers})
    if ffps is not None:
        n = sum(run.get("fps_features", 0) for run in runs.values())
        require(n > 0, "kernel fps_features never launched on phase 21's path")
        rows.append({"name": "fps_features", "route": "cuda", "source": FFPS_KERNEL[0],
                     "replaces": FFPS_KERNEL[1], "launches": n, **ffps})
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s from the argument parse")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
