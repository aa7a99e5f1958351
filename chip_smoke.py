#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sassd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc and g++.
Phases, each of which fails the run (nonzero exit, no result line):

1. environment: torch/CUDA versions, the card, its power limit, nvcc;
2. build: the C++ host library (g++) and the CUDA kernels (nvcc), timed;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes of the car-config path, with stated tolerances,
   and both timed with CUDA events. K4 (sparse conv, at the sparse
   ladder's 10 convs, each with its found-slot fraction and bound) and K5
   (dense-tail scatter) run on the host plans of synthetic car scans; K6
   (index maps + window plans, a scan's six plans in one call) and K7
   (downsample) build the device rulebook of those scans, which must
   equal both the plain versions and the C++ host rulebook bit for bit;
4. host plans: car-config inference (full widths, random weights from a
   seed) over 4 synthetic scans at batch 1 and once at batch 2, with the
   launch counters reset just before and read just after; K1-K5 must have
   launched, detections must be finite, the batch-2 run must agree with
   the batch-1 runs, and one scan run on the CPU (plain versions) must
   agree with the card;
5. device plans (model.host_plans=False): the same scans and checks, the
   rulebook built on the card; K1-K7 must have launched, and every scan's
   detections must match the host-plans phase's;
6. serving (test.device_input="points"): a 4-scan synthetic KITTI val
   split (frustum scans at car range) written to a temporary directory,
   run_inference over it at batch 1 and batch 2 with the launch counters
   reset just before and read just after; K1-K9 must have launched. On
   every scan whose in-range voxel count is under the cap, the detections
   must match the host-input (device_input="voxels") run's and batch 2's
   must match batch 1's; one scan served on the CPU (plain versions) must
   match the card. The result files are written, evaluate's KITTI AP table
   is printed, and the serving step is timed with the raw-points upload
   inside the clock.

7. training: a 4-scan car-range synthetic KITTI train split; one
   forward_train + backward at batch 2 on the card against the same on
   the CPU (plain versions): every loss within 1e-3 relative, equal
   guided-anchor and PSWarp assignment counts, and the gradients against
   a float64 CPU step: the global norm within 2e-3, each module within
   1e-2 relative L2. Then train_model for 3 epochs of 2 steps with the launch
   counters reset just before and read just after: K1, K3, K3b, K4, K5,
   K5b, K10, K11 and K12 must have launched, every logged loss must be
   finite, no update skipped, and the last checkpoint must restore to the
   trained parameters. K12 is held bitwise against its plain version on
   the first card step's inputs (captured). The train step is timed (host
   clock, synchronised, loader excluded) beside the host leg of a batch
   (voxelize + mask + the C++ train rulebook);
8. three-class training on device plans (multi_config, host_plans=False,
   batch 1): a 4-scan car-range synthetic three-class KITTI train split,
   its info file and GT database written by the port's data.create_data,
   and KittiDataset(train=True) with the GT-sampling augmentor. On an
   augmented sample the device train rulebook (strideT and aux plans
   included) must equal the C++ one bitwise, and one forward_train +
   backward on device plans must agree with the same step on host plans
   on the card (losses 1e-5, gradients 1e-4 per module: only the atomics'
   order differs); a diagnostic line compares K15's
   3-NN sets with a float64 direct-difference 3-NN (no gate). Then
   train_model for 2 epochs of 4 steps with the ring aux and again with
   the exact aux, launch counters reset just before and read just after:
   K6, K7 and K13 must launch in both, K14 in the ring run only, K15 and
   K11's backward in the exact run; every logged loss finite, no update
   skipped. One batch-1 step of each must launch K13 once (the three
   levels' transpose plans in one launch) and K14 once (the three levels'
   aux plans in one launch; ring) or not at all (exact). The steps
   at batch 1 and 2 are timed beside a host-plans step.

9. long range (long_range_config(), grid [40, 1600, 2048], 102,400
   anchors), banded over 4 y-bands (parallel.strategy="banded", the
   user's configs/long_range_banded.py) against replicated on device
   plans, at full width: a 4-scan long-range synthetic KITTI train split
   (frustum scans of about 29,000 voxels: every level of both runs under
   its cap, no band overflow; the voxel count of every level is printed)
   and one denser timing scan (~70,000 voxels). Kernel checks at these
   shapes: K16 (band partition) bitwise, also with a cap that drops
   members; K7 with each band row's y limit bitwise, and replicated on the
   timing scan's level 0 (timed beside torch.unique); K11 with per-row grid
   origins (rows, weights, output bitwise; backward 1e-5). forward_test
   banded vs replicated on two scans at batch 1 (matched detections, boxes
   1e-2, scores 1e-3; launch counts of each run); one forward_train +
   backward at batch 2 banded vs replicated (losses 1e-3; the gradients of
   the objective without the PSWarp loss, which follows the guided
   anchors' top-k, whose near-ties flip between float32 runs: norm 2e-3,
   each module 1e-2; the PSWarp module's full gradients 1e-2; BatchNorm
   running-statistic updates 2e-3; printed beside a replicated step on
   inputs one float32 ulp off); then
   train_model of the banded config for 2 steps at batch 2 (8 band rows):
   K16, K7 and K11 (with a limit, with origins) must launch, every logged
   loss finite, band_overflow 0; one banded train step must launch K13
   and K14 once each. Timed: the timing scan at batch 1, banded
   and replicated in turns, and the train step at batch 2.

10. data-parallel training and evaluation (parallel/dist.py): 2 steps of
   make_train_step on phase 7's config, scans and start weights, global
   batch 2 with the ring aux. 10a: in a one-rank NCCL group against the
   same steps with no group, and the no-group steps once more (a
   determinism control). The group's collectives at world size 1 are
   copies: the losses, the BatchNorm buffers and every coalesced
   reduction must be bitwise equal; the gradient norms and parameters
   bitwise too where the control repeats itself bitwise, and otherwise
   (atomics in the backward) within phase 8's atomics-order tolerances,
   each pair's largest difference printed. K1, K3, K3b, K4, K5, K5b,
   K10, K11 and K12 must launch in the group's run. 10b: two ranks on
   the one card over gloo (NCCL refuses two ranks on one device), each a
   subprocess of this script with a timeout, local batch 1: after 2 steps
   their parameters and buffers must be bitwise equal, and step 1's
   all-reduced losses (1e-3), gradient norm (2e-3) and each module's
   reduced gradients (1e-2 relative L2) must match 10a's single-process
   batch-2 step. 10c: evaluate on the same pair at batch 1 over phase 6's
   4 val scans (raw points served on the card): rank 1 returns (None,
   ""), and the detections rank 0 gathers, deduplicated, must match a
   single-process run_inference's (boxes 1e-2, scores 1e-3). Each rank's
   kernels of its path must launch. Phase 10's wall time and each gate's
   largest difference are printed.

11. the CLIs (sassd_tpu_torch.tools), each process run as
   ``chip_smoke.py --cli-worker`` (the tool's main with its arguments,
   the launch counters reset just before and read just after, every
   train step's metrics and run_inference's annotations recorded), on
   the card by default. 11a: ``tools.train configs/car.py --synthetic
   --epochs 2`` at full width, once uninterrupted and once with
   ``--epochs_per_run 1`` (exit 75, then a relaunch that exits 0): the
   final step, the saved and the final optimizer count, lr and momentum
   equal between the two; every step finite, none skipped; the
   relaunch's first step's losses bitwise equal to a step taken here
   from the same checkpoint on the same batch; the final weights'
   distance from the uninterrupted run printed beside that of a second
   uninterrupted run, the control (not gated: K11's backward atomics);
   K1, K3, K3b, K4, K5, K5b, K10, K11 and K12 launched in each run. 11b:
   ``tools.test`` on the relaunched run's final checkpoint with
   ``--out``: its annotations match an in-process run_inference of the
   same weights as sets (boxes 1e-2, scores 1e-3), its AP text equals
   evaluate's, a result file per scan; K1-K5 launched. 11c:
   ``configs/multi_convergence_r3.py`` (three classes, device plans,
   weight decay on every parameter, the GT database) through a wrapper
   config that changes only its paths and its epochs, on a small corpus
   written by ``tools.make_synth_corpus``: one epoch at batch 1, every
   step finite, every parameter decayed, K6, K7, K13 and K14 among the
   kernels launched. 11d: the PointNet VFE (model.vfe_type="pointnet")
   at car width: forward_test on the card vs the CPU as sets, and one
   train step's losses within 1e-3 of the CPU forward_train's. The CLI
   processes run up to four at a time beside 11d; phase 11's wall
   time and each process's are printed.

12. the spatial strategies across ranks (parallel/mesh.py,
   parallel/spatial.py): four rank subprocesses of this script
   (``--sp-worker``), each with a timeout, sharing the card over gloo
   (NCCL refuses two ranks on one device), on phase 9's split and scans
   at full width, seeded weights. 12a: the user's long-range banded
   layout (4 bands) over 4 ranks, 1 x 4: forward_test at batch 1 on both
   comparison scans against phase 9's single-process banded run (matched
   sets, boxes 1e-2, scores 1e-3) and one forward_train + backward at
   batch 2, reduced over the ranks, against phase 9's single-process
   banded step at phase 9's gates (losses 1e-3, gradients without the
   PSWarp loss 2e-3 norm / 1e-2 a module, PSWarp's own 1e-2, BatchNorm
   updates 2e-3), band_overflow 0, and on each rank K1-K6, K3b, K5b, K7',
   K10, K11', K12-K14 and K16 launched. 12b: long_range_config() with
   strategy="spatial", spatial=2 over 2 ranks against the replicated run,
   with the same gates and kernels (K7 and K11 without limit and
   origins, no K16). 12c: banded over 2 bands on 4 ranks, 2 x 2:
   train_model for 2 steps at global batch 2; the four replicas bitwise
   equal, every loss finite, no update skipped. Phase 12's wall time and
   each gate's largest difference are printed; the kernel rows gain each
   rank's launches of 12a.

13. model.compute_dtype="bfloat16" (ROADMAP A.7). 13a: K4-bf16 at the
   sparse ladder's 10 convs at batch 1 (scan 0's host plans), its input
   gradients at batch 2 (the train plans' 9 convs and the PointNet VFE's
   4-wide input, zero-padded to 16 columns) and K10-bf16 at batch 2 (10
   convs), against the plain version summed in float64: each element
   within 1e-5 times its sum of |products|, and bitwise equal over two
   calls; each whole wrapper call (the bfloat16 copies of its operands
   included) timed (CUDA events, 3 warm-ups, the mean of 20 calls, and
   torch.profiler's kernel time, with its split by kernel) beside K4 /
   K10 at the same shapes, the plain version and one torch.matmul of the
   gathered im2col (the gather not timed) in bfloat16 and in float32
   (K4's and K10's yardstick), with its bound (bytes at 3.35 TB/s or the
   found slots' operations at 989 TFLOP/s); then K4-bf16 at car shapes
   on the edge cases of its compaction, on int16 and int32 plans (a tile
   with no found row, a tap found in one row, every tap found in every
   row, a ragged last tile, Cin 4 and the PointNet VFE's input gradient),
   each at the same gate and bitwise equal over two calls. 13b-d hold
   the card's bfloat16 runs to runs that take the same rounding points:
   two runs that sum in float32 in different orders round a value that
   lies within that difference of a bfloat16 rounding boundary to
   different neighbours, and the BEV trunk and train-mode BatchNorm's backward
   amplify that one-ulp step, so the CPU's run is forced to the card's
   neighbour at exactly those ties (tests/torch_bf16_points.py records
   every rounding point of the card's run: each sparse conv's input and
   output gradient, each bfloat16 dense conv's input, output, output
   gradient, input and weight gradients, the tail's 1x1x1 operands; a
   tie lies within BF16_SUM_RTOL of its sum of |products| from the
   midpoint at a dense conv's own outputs, within BF16_TIE_RTOL of its
   tensor's largest magnitude elsewhere); at every forward point it must
   round every other value as the card did (the backward's points are
   forced at ties too, but train-mode BatchNorm's backward amplifies the
   float32 differences reaching them past any tie, so their values apart
   are printed); a float32 card run is the control that each gate must
   fail. 13b: car forward_test in bfloat16 on host plans and served
   from raw points (test.device_input="points", phase 6's split),
   launches counted; scan 0 held to the forced CPU run (detections as
   the same set, boxes 5e-2, scores 1e-2, none unmatched; the largest
   gaps printed). 13c: one car train step at batch 2 in bfloat16 on
   device plans with the ring aux (phase 7's batch) against the forced
   CPU step: every loss finite and within 1e-2, the gradient norm and
   each module's gradients within 2e-2 (relative L2); each module's
   distance from phase 7's float64 step printed beside the float32 card
   step's; and each of its bfloat16 dense convs fed again its own
   recorded operands (input, weight, output gradient): output, input
   and weight gradients each the exact conv of the rounded operands
   (float64) rounded to bfloat16, or the other neighbour at a tie
   (BF16_WGRAD_RTOL for the weight gradients, whose sums run over every
   position of the map; the float32 convs must fail). 13d: the
   long-range banded config in bfloat16, forward_test at batch 1 on
   phase 9's two comparison scans (full depth), held to the replicated
   bfloat16 forward on the card at 13b's gate.
   13e: serving at batch 1 and the train step at batch 2, float32 and
   bfloat16 in turns, on the host clock, synchronised (for orientation,
   no claim). Every bfloat16 run must launch its path's kernels with
   K4-bf16 and K10-bf16 in place of K4 and K10, and no K4 or K10.
   ``--bf16-only`` runs phase 13 alone (after phase 7 and phase 9's
   inputs, which it needs); ``--kernels-only`` includes 13a.

14. persistent-plan serving (test.serve_persistent_plans) and the two RPN
   similarities (train.rpn_similarity "RotateIou2dSimilarity" and
   "DistanceSimilarity"). 14a: K17 (the index-map delta update) carries
   the three plan-building levels' maps at their full shapes, one call (one
   launch) a scan for the three, through phase 6's 4 car scans in
   sequence and through the edge cases (the first scan with no previous
   keys, the last scan twice, an empty scan, a scan at each level's cap,
   the first scan again): after every call each map must equal its plain
   version's and K6's fresh map bit for bit. K17 is timed for the three
   levels in one call and at each level alone (events, replay,
   torch.profiler's kernel time, host clock) beside K6's map entry point
   (memset + scatter) and two index_put_ calls a level. 14b:
   run_inference at batch 1 with the flag over phase 6's split, launch
   counters reset just before and read just after: K17 1 launch a scan,
   K6's map 0, K6's plans 1 (as in one persistent step); the plans bit
   for bit those of the per-scan run, the annotations bitwise or the same
   sets; both serving steps timed in turns on the host clock
   (synchronised, upload inside) and the rulebook stage by the profiler.
   14c: one car forward_train + backward at batch 2 (phase 7's batch)
   with RotateIou2dSimilarity on the card, the CPU and the CPU in float64
   at phase 7's gates, with equal RPN positive and negative counts and K1
   launched once in each similarity call (a sample and class slice); a
   DistanceSimilarity forward_train on the card and the CPU (equal
   assignment counts, finite losses); K1 at the targets shape (70,400
   anchors x 64 GT slots, criterion -1) against its plain version and
   timed. The kernel rows gain K17's and that K1 row.
15. model.plan_lookup="sorted", the device rulebook resolved by binary
   search over each level's sorted keys with no index map. 15a: K18 (a
   scan's six plans in one call), K19 (transpose plans) and K20 (aux
   plans) bitwise against their plain versions and against K6's plans,
   K13 and K14 through the maps, on phase 6's 4 car scans at batch 1,
   phase 7's train batch of 2, phase 9's long-range timing scan and its
   comparison batch's 8 band rows; K18 timed at phase 6's scan 0 (and at
   the long-range scan) beside K6's six plans, K19 and K20 at phase 7's
   batch, each read four ways beside its plain version and its yardstick
   (torch.searchsorted of the same window starts: the search alone), its
   bound (bytes) and the search's dependent-load chain as an estimate.
   15b: run_inference of phase 6's split at batch 1 and 2, dense then
   sorted: the same detection sets at phase 6's gates, K18 once a step
   and K6 never, and the rulebook stage's kernels a scan by the profiler
   in turns. 15c: phase 7's car train step at batch 2 on device plans and
   15d: phase 9's banded long-range train step at batch 2, sorted against
   dense at the device-vs-host-plans gates, K18, K19 and K20 once a step
   and K6, K13 and K14 never. 15b-d print the peak device memory of the
   dense and the sorted run. The kernel rows gain K18's, K19's and
   K20's.
16. the last entry points (tools.visualize, tools.sweep_guided), the car
   config at full width with seeded weights scaled by RELU_GAIN, saved as
   a .pt and read back through the tools' own loaders. 16a: the
   visualizer's scene (the synthetic scene of seed 0, its detections) on
   the card and on the CPU, launch counters reset just before and read
   just after the card's: K1-K5 must launch, the points and GT boxes
   bitwise, the detections the same sets (boxes DET_BOX_ATOL, scores
   DET_SCORE_ATOL), the GT rings bitwise and the matched detections' rings
   within DET_BOX_ATOL. 16b: the probe over the train scans of a corpus
   written by tools.make_synth_corpus at CLI_CORPUS (its GT database
   pasting, as in training), caps P16_CAPS, on the card and on the CPU:
   K1 must launch, the anchor scores agree within DET_SCORE_ATOL, G
   equal, and n_pass, n_pos, kept_pos_* and trunc_* equal except where
   counted near-ties explain the difference (a score within
   P16_SCORE_TIE of train.anchor_thr, a best IoU within P16_IOU_TIE of
   train.extra_pos_iou, or a positive's score within twice the scores'
   largest card-vs-CPU difference of a cap's cut). The phase prints its
   wall time and each gate's largest difference beside the card. No
   kernel row is new; the launches of 16a and 16b join every row's.

Phase 3 holds K1 (rotated overlap) in all four criteria within K1_ATOL
of its plain version and at exactly +0.0 on every pair that its
separation cull rejects, on the 2008-box set and on phase 6's NMS input
(the sorted boxes rotate_nms hands to K1 in one served car scan,
captured), printing the near pairs and a hash of each output, equal
across checkouts exactly when every value is. It holds K2 (NMS keep
flags) bitwise against the plain greedy at
N = 2000 and at 1, 63, 64, 65 and 2113 boxes (the sweep's 64-box blocks
and its register words), at thresholds 0.1 and 0.5. It also holds K8
(device voxelizer) and K9 (anchors mask) against
their plain versions, bitwise, on the car scans (at the 20,000-voxel cap,
so the lowest-key truncation runs; K9 at batch 1, 2 and 5 on the car and
the three-class corner tables) and on one frustum scan, K8 also on a
batch of two with one sample empty and on phase 9's long-range timing
scan (262,144-point cap, 80,000 voxels: the bitmap follows the grid); and the
training kernels at batch 2 on the train plans of the car scans: K10
(sparse-conv weight gradient, also bitwise equal over two calls) and K4's
input gradients at the ladder's 10 training convs, K11 (ring 3-NN
interpolation, forward and backward), K12 (aux targets), K3b (PSWarp
backward, also bitwise equal over two calls, there and on phase 7's first
train step's inputs) and K5b (densify backward); and the kernels of
training on
device plans, at batch 2 on the same scans: K13 (the three levels'
transpose plans, one call; also against the forward stride plans
inverted, its parent design, and again at phase 9's band rows) and K14
(the three levels' aux ring plans, one call) against their plain versions
and the C++ train rulebook, bitwise, and K15 (exact 3-NN) at the full
level sizes (rows, weights and output bitwise, its backward through
K11's).

K5, K5b, K6's level-0 map, K7 (the whole op; with a limit, at the band
rows) and K13 are also timed beside one PyTorch call that computes their
work (library_ms), a yardstick the port never calls; no single call
computes K1's, K2's, K4's, K8's, K9's, K10's or K15's function (each row
says why). K6's other launches of a train step at batch 1 (the maps of
levels 1-3, each plan alone) print torch.profiler's time beside their
bounds; the six plans in one call are read four ways (as K12-K14 below)
beside their plain version; no one call computes them (the window's tap
cells and edge masks take several calls before a gather). K6's map and
its yardstick are also replayed in turns
(map, yardstick, yardstick, map). K8's rows carry the parent design's
torch.sort of the same keys alone (sort_ms). K3 (at 2 x 2048 boxes and
at the serving shape: phase 6's first scan's part map and guided boxes,
batch 1, under inference_mode) and K3b print torch.profiler's kernel
split and their host path taken apart by cProfile (host_split), as
diagnostics; K3b also prints its replay at several tile heights of its
second pass and a replay of torch.zeros of its d_map, K3 a replay of a
one-element fill (the replay's floor), each on its own line. K2, K3,
K3b, K8, K15 and the
yardsticks are also timed as CUDA-graph replays (graph_ms,
library_graph_ms: the device's time without the host's launch path),
except torch.unique,
which reads its output's size back to the host and cannot be captured.
K5b, K12, K13, K14 and the yardsticks are timed over 100 calls each, K5b and
its gather also with the L2 cold before each call (cold_l2_ms). K1 (at
both inputs) and K9 (car batch 1 and 2, and on no voxels: all but its
scatter) are timed by events and graph replay. K11 and
K11' (per level: the forward, the backward with its memset of d_feats,
that memset alone, the zeroing as torch.zeros, and forward + backward
replayed from one graph) and K16 are timed by events and graph replay.
K1, K2, K8, K9, K11, K11' and K16 also print torch.profiler's device
time by kernel
(kernel_split) after their timed runs, as a diagnostic only: those
totals have read below the replay of the same call, so no row carries
them. K12 (batch 2), K13 (its three levels in one call, at batch 2 and
at phase 9's band rows, beside its yardstick read the same way) and K14
(its three levels in one call, at batch 2 and at phase 8's batch-1 shape)
are read four ways, each in their row: events
(ms), replay (graph_ms), torch.profiler's kernel time (profiler_ms, with
kernel_split: the ranking of device time, since a lone replay reads
0.006-0.015 ms even for a one-element fill) and the host clock a call
(host_us, with host_split's parts printed); K14 also prints the
torch.full of its plans' buffer alone, the write part of its time.

Every kernel row carries its bound: the larger of the bytes it must move
(each input read once, each output written once, at this run's active
counts) over the H100's 3.35 TB/s and its operations over the 67 TFLOP/s
of float32 outside the tensor cores.

The second-to-last lines are a JSON object of the kernels and the card's
name and power limit; the last line is the JSON result object.

    python3 chip_smoke.py --kernels-only

runs phases 1-3 and phase 9's kernel checks and prints the kernel rows
under the key kernels_only (without launch counts) and the card, and no
result line: the kernels of two checkouts can be timed in one call, each
from its own root.

The device rulebook's C calls a step are checked in the full run: K6's
maps 3 and its plans 1 a serving or inference rulebook, 4 and 1 a train
rulebook (phases 6, 8, 9 and each rank of 12a), K17 1 and the plans 1 a
persistent scan (14b); the full run also prints the peak device memory
(torch.cuda.max_memory_allocated) of phases 6, 8 and 9.

    python3 chip_smoke.py --data-parallel-only

builds the kernels and runs phase 10 alone, with no result line.

    python3 chip_smoke.py --cli-only

builds the kernels and runs phase 11 alone, with no result line.

    python3 chip_smoke.py --spatial-only

builds the kernels and runs phase 12 alone (its references made as
phase 9 makes them), with no result line.

    python3 chip_smoke.py --phase14-only

builds the kernels and runs phase 14 alone (14c on a train split written
as phase 7 writes it), printing its kernel rows under the key
phase14_only, with no result line.

    python3 chip_smoke.py --phase15-only

builds the kernels and runs phase 15 alone (its train batch and
long-range split written as phases 7 and 9 write them), printing its
kernel rows under the key phase15_only, with no result line.

    python3 chip_smoke.py --phase16-only

builds the kernels and runs phase 16 alone, printing its gates under the
key phase16_only, with no result line.

    python3 chip_smoke.py --gloo-probe

runs, for each of all_reduce, all_gather and send/recv, two gloo ranks
on the card that try it on CUDA tensors, and prints each one's exit
codes, with no result line (parallel/dist.py moves rows between ranks
by all-gathers and all-reduces only).
(``--dp-worker`` is the entry of phase 10's rank subprocesses,
``--cli-worker`` that of phase 11's CLI processes, ``--sp-worker`` that
of phase 12's ranks and ``--probe-worker`` that of the probe's.)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_SCANS = 4

# tolerances (see the kernel notes in sassd_tpu_torch/csrc)
K1_ATOL = 1e-4     # m^2 intersection area; float32 with -fmad=false
K3_ATOL = 1e-5     # mean of 28 bilinear samples; only the sum order differs
K4_ATOL = 1e-4     # O(1) outputs, float32 sums of up to 27 * 64 products
K4_RTOL = 1e-4     # in another order than cuBLAS's GEMM
# K5-K9 are held bitwise: a scatter of unique keys, integers, copies of
# points, and float32 sums of integer counts below 2^24
DET_SCORE_ATOL = 1e-3   # card vs CPU detections: cuDNN vs CPU conv sums
DET_BOX_ATOL = 1e-2
# training kernels, relative to the largest magnitude of the plain result:
# K10 and K4's input gradients sum thousands of rows in another order; the
# K11 backward adds with atomics in an order that changes from run to run;
# K3b sums each d_map cell in box order where autograd sums each tap apart
# (and is bitwise equal over two calls). K11's forward, K12 and K5b are
# held bitwise.
TRAIN_GRAD_RTOL = 1e-5
TRAIN_LOSS_RTOL = 1e-3  # card vs CPU train step: cuDNN vs CPU conv sums
# card train-step gradients against a float64 CPU step: the global norm,
# and each module's gradients in relative L2 (float32 rounding, amplified
# by the batch-statistics backward of train-mode BatchNorm)
TRAIN_GNORM_RTOL = 2e-3
TRAIN_GRAD_L2 = 1e-2
# phase 8, device vs host plans on the card: the same cuDNN algorithms on
# bitwise-equal rulebooks leave only the atomics' order (measured on the
# H100: losses equal, grad norms equal to 7 digits, module rel L2 <= 1.1e-6)
PLANS_LOSS_RTOL = 1e-5
PLANS_GNORM_RTOL = 1e-5
PLANS_GRAD_L2 = 1e-4
N_TRAIN_EPOCHS = 3     # of 2 steps at batch 2 over the 4 train scans
N_MULTI_EPOCHS = 2      # phase 8: of 4 steps at batch 1
# phase 9: frustum ground returns of the long-range comparison scans (about
# 29,000 voxels, under every replicated and per-band cap), and the banded
# step's BatchNorm running-statistic updates against the replicated ones,
# relative to each buffer's largest update
LR_GROUND = 60000
BN_UPDATE_RTOL = 2e-3

# phase 10: data-parallel steps; each rank subprocess's time limit and
# the collectives' timeout of every process group the phase makes
DP_STEPS = 2
DP_WORKER_TIMEOUT_S = 300
DP_GROUP_TIMEOUT_S = 120
ADDR_IN_USE = ("address already in use", "eaddrinuse")
# phase 11: the CLIs; each CLI process's time limit, the car runs' epochs
# and the three-class run's corpus (make_synth_corpus) in scans
CLI_TIMEOUT_S = 600
CLI_EPOCHS = 2
CLI_CORPUS = (4, 1)
CLI_CAR = os.path.join(HERE, "configs", "car.py")
CLI_MULTI = os.path.join(HERE, "configs", "multi_convergence_r3.py")

# the sparse ladder's 10 convs (models/backbone.py VxNet) as distinct
# shapes: name, plan, input level, Cin, Cout, convs of that shape
LADDER = (("conv0.0", "plan_subm0", 0, 4, 16, 1),
          ("conv0.1", "plan_subm0", 0, 16, 16, 1),
          ("down0", "plan_stride1", 0, 16, 32, 1),
          ("conv1", "plan_subm1", 1, 32, 32, 2),
          ("down1", "plan_stride2", 1, 32, 64, 1),
          ("conv2", "plan_subm2", 2, 64, 64, 3),
          ("down2", "plan_stride3", 2, 64, 64, 1))

# tile heights of K3b's pass B replayed beside the one in use (at 96
# columns a 5120-float tile holds 53 rows)
K3B_ROWS_TRIED = (8, 16, 25, 50)

# the card's peaks the bounds are taken against (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12           # dense, tensor cores

# phase 13, model.compute_dtype="bfloat16": K4-bf16 and K10-bf16 against
# their plain versions summed in float64, per element relative to the sum
# of |products| (bfloat16 operands: the products are exact, only the
# float32 sums' order differs); the card's runs against the CPU's with
# the CPU's ties forced to the card's neighbours (a value before a
# rounding within BF16_TIE_RTOL of its tensor's largest magnitude of the
# midpoint: the two devices' float32 sums in another order, cuDNN's
# algorithms among them): detections, the train step's losses, gradient
# norm and modules
BF16_SUM_RTOL = 1e-5
# a dense conv's weight gradient sums over every position of its map (70,400
# products an element for the car's BEV at batch 2): cuDNN's float32 sums
# there lie farther from the exact sum, up to 8.2e-5 of the sum of
# |products| at the car's shapes
BF16_WGRAD_RTOL = 1e-4
BF16_TIE_RTOL = 1e-5
BF16_BOX_ATOL = 5e-2
BF16_SCORE_ATOL = 1e-2
BF16_MODULES = ("vxnet", "bevnet", "head", "pswarp", "aux")
BF16_LOSS_RTOL = 1e-2
BF16_GNORM_RTOL = 2e-2
# an estimate, printed beside K15's times and kept out of the kernel rows:
# float32 instructions issued one by one at 128 lanes x 132 SMs x 1.98 GHz
# (the clock at which 67 TFLOP/s counts an FMA as two operations)
INSTR_PER_S = 128 * 132 * 1.98e9


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"<{cmd[0]} unavailable: {e}>"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per replay of fn() captured in a CUDA graph: the
    device's time without the host's launch path (Python, ctypes)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters=iters)


def cold_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds of fn() on the card with a cold L2: 256 MB (five
    times the L2) are written before each call, and CUDA events bracket
    fn() alone. The write outlasts fn()'s host path, so the events see
    the device's time."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    total = 0.0
    for _ in range(iters):
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_split(fn, iters: int = 10, counts: dict = None) -> dict:
    """Device milliseconds per call of each kernel (and memset) that fn()
    runs, by name, from torch.profiler over `iters` calls: the parts of one
    wrapper call. `counts`, where given, receives each name's launches."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = re.sub(r"\(anonymous namespace\)::|^void ", "",
                          e.key).split("(")[0][:60]
            out[name] = out.get(name, 0.0) + (e.self_device_time_total
                                              / iters / 1e3)
            if counts is not None:
                counts[name] = counts.get(name, 0) + e.count
    return out


def timed(fn, iters: int = 20) -> dict:
    """fn()'s milliseconds by CUDA events (ms) and replayed from a CUDA
    graph (graph_ms)."""
    return dict(ms=cuda_ms(fn, iters=iters), graph_ms=graph_ms(fn, iters))


def fmt_timed(t: dict) -> str:
    return f"{t['ms']:.4f} ms ({t['graph_ms']:.4f} replayed)"


def fmt_split(fn) -> str:
    """kernel_split(fn) as a diagnostic: torch.profiler's per-kernel totals
    have read below the replay of the same call, so they are printed after
    the timed runs and kept out of the kernel rows."""
    parts = ", ".join(f"{k} {v:.4f}" for k, v in kernel_split(fn).items())
    return f"profiler totals a call (diagnostic, not in the row): {parts}"


# host_split's groups, by the first pattern a cProfile entry (file:function)
# matches: the Python functions and builtins of one wrapper call
HOST_GROUPS = (("check", ("check",)),
               ("device context", ("torch/cuda/__init__.py",)),
               ("allocation", ("torch.empty", "torch.zeros", "new_empty")),
               ("autograd", ("autograd/function.py", "method apply",
                             "_functorch", "save_for_backward")),
               ("launch (ctypes)", ("cuda.py:launch", "RawStream",
                                    "_cuda_getDevice")))


def host_split(fn, iters: int = 200):
    """The host path of one call of fn(): the host clock per call over
    `iters` calls (us), and as a diagnostic (text) cProfile's self time per
    call (each Python function and builtin; the profiler's own cost
    inflates each), summed by HOST_GROUPS, and its largest entries. The
    ctypes call runs inside cuda.py's Kernel.launch and counts there."""
    import cProfile
    import pstats
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    wall_us = (time.perf_counter() - t) * 1e6 / iters
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(iters):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    keys = [(f"{path}:{name}", tottime * 1e6 / iters) for (path, _, name), (
        _, _, tottime, _, _) in pstats.Stats(prof).stats.items()
        if "chip_smoke.py" not in path]
    groups = {g: 0.0 for g, _ in HOST_GROUPS}
    groups["other"] = 0.0
    for key, us in keys:
        g = next((g for g, pats in HOST_GROUPS
                  if any(p in key for p in pats)), "other")
        groups[g] += us
    top = sorted(keys, key=lambda kv: -kv[1])[:8]
    return wall_us, (
        f"host path a call (diagnostic): {wall_us:.1f} us by the host "
        f"clock; cProfile self us a call: "
        + ", ".join(f"{g} {us:.1f}" for g, us in groups.items())
        + "; largest: "
        + ", ".join(f"{k.split('/')[-1][:48]} {us:.1f}" for k, us in top))


def measured(fn, what: str, iters: int = 20) -> dict:
    """fn() by CUDA events (ms), replayed from a CUDA graph (graph_ms), by
    torch.profiler's kernel time a call (profiler_ms, the sum of
    kernel_split) and by the host clock a call (host_us), each printed:
    the four readings of a small kernel whose event time is mostly its
    host path. Rank device time by profiler_ms (a lone replay reads
    0.006-0.015 ms even for a one-element fill), the host path by ms and
    host_us."""
    t = timed(fn, iters)
    for _ in range(3):      # the profiler can drop some calls' kernels
        counts = {}
        split = kernel_split(fn, counts=counts)
        if split and min(counts.values()) >= 10:
            break
    host_us, host_text = host_split(fn)
    print(f"  {what}: kernel {fmt_timed(t)}; profiler "
          + (", ".join(f"{k} {v:.4f}" for k, v in split.items())
             or "saw no kernel (not measured)")
          + f" ms a call; {host_text}")
    return dict(**t, profiler_ms=sum(split.values()) if split else None,
                kernel_split=split, host_us=host_us)


def bound(nbytes: float, ops: float, flops: float = FP32_FLOPS) -> dict:
    """The least time the card could take for the work: bytes over the
    memory rate or operations over the rate of their type (float32 unless
    `flops` says otherwise), whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=float(nbytes), bound_ops=float(ops))


def add_bounds(rows, flops: float = FP32_FLOPS) -> dict:
    """Sum of the bounds of several calls timed as one row."""
    nbytes = sum(r["bound_bytes"] for r in rows)
    ops = sum(r["bound_ops"] for r in rows)
    out = bound(nbytes, ops, flops)
    out["bound_ms"] = sum(r["bound_ms"] for r in rows)
    return out


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    ref = ref.detach().double()
    return float((got.detach().double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-30))


def grad_ms(out, inputs, cot, iters: int = 20) -> float:
    """Milliseconds of one autograd backward of `out` (graph retained)."""
    import torch
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, cot,
                                               retain_graph=True),
                   iters=iters)


def keys_bzyx(torch, keys, shape_zyx):
    """The (b, z, y, x) index tensors of the active rows of [B, M] keys."""
    from sassd_tpu_torch.ops import sparse as sp
    ok = keys != sp.INVALID_KEY
    b = torch.nonzero(ok)[:, 0]
    k = keys[ok].long()
    _, h, w = shape_zyx
    return b, k // (h * w), (k // w) % h, k % w


def reset_launches():
    from sassd_tpu_torch.ops import cuda
    for kern in cuda.KERNELS.values():
        kern.launches = 0


def read_launches() -> dict:
    from sassd_tpu_torch.ops import cuda
    return {k: v.launches for k, v in cuda.KERNELS.items()}


def train_step_ms(torch, step, model, batch, n: int = 3):
    """Host-clock ms of n synchronised train steps after one warm-up."""
    step(model, batch)
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t = time.perf_counter()
        step(model, batch)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def nms_boxes(rng, n: int):
    """NMS-like candidates: clusters of jittered car boxes over the KITTI
    range, so that many pairs overlap."""
    import numpy as np
    n_obj = max(n // 20, 1)
    centers = np.stack([rng.uniform(0, 70.4, n_obj),
                        rng.uniform(-40, 40, n_obj)], 1)
    which = rng.integers(0, n_obj, n)
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = centers[which] + rng.normal(0, 0.6, (n, 2))
    b[:, 2] = rng.uniform(1.4, 1.9, n)
    b[:, 3] = rng.uniform(3.2, 4.6, n)
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


DEGENERATE = [
    [0.0, 0.0, 2.0, 4.0, 0.0], [0.0, 0.0, 2.0, 4.0, 0.0],
    [2.0, 0.0, 2.0, 4.0, 0.0], [0.0, 0.0, 1.0, 2.0, 0.0],
    [10.0, 10.0, 2.0, 4.0, 0.0], [0.5, 0.0, 2.0, 4.0, 0.0],
    [0.0, 0.0, 2.0, 4.0, 1.5707963], [0.0, 0.0, 2.0, 4.0, 3.1415927],
]


# criterion-2 areas of pairs of DEGENERATE, appended last to a box set
DEGENERATE_AREAS = {(0, 1): 8.0, (0, 2): 0.0, (0, 3): 2.0, (0, 4): 0.0,
                    (0, 6): 4.0, (0, 7): 8.0}


def k1_check(torch, riou_kernel, boxes, what: str,
             degenerate: bool = False) -> dict:
    """K1 on [N, 5] card boxes against itself in all four criteria: within
    K1_ATOL of the plain version, and exactly +0.0 on every pair that the
    separation cull rejects; with `degenerate`, the last boxes are
    DEGENERATE and their criterion-2 areas must be DEGENERATE_AREAS.
    Returns the largest error, the near-pair count and a hash of each
    criterion's bytes (equal across checkouts exactly when every value is
    bitwise equal)."""
    import hashlib
    near = riou_kernel.near_pairs_plain(boxes, boxes)
    err, sums, bad, deg = 0.0, {}, {}, {}
    for crit in (2, -1, 0, 1):
        got = riou_kernel.rotate_overlap(boxes, boxes, crit)
        ref = riou_kernel.rotate_overlap_plain(boxes, boxes, crit)
        err = max(err, float((got - ref).abs().max()))
        sums[crit] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(
            )[:16]
        bad[crit] = int((got.view(torch.int32)[~near] != 0).sum())
        if crit == 2 and degenerate:
            k = len(DEGENERATE)
            tail = got[-k:, -k:].cpu().numpy()
            deg = {ij: float(tail[ij]) for ij, v in DEGENERATE_AREAS.items()
                   if abs(tail[ij] - v) > 1e-2}
    n = boxes.shape[0]
    n_near = int(near.sum())
    # near pairs per 64 x 64 tile of the kernel's grid: a block clips its
    # own tile's near pairs
    nt = -(-n // K1_TILE)
    grid = torch.zeros((nt * K1_TILE, nt * K1_TILE), dtype=torch.int32,
                       device=near.device)
    grid[:n, :n] = near.int()
    per = grid.view(nt, K1_TILE, nt, K1_TILE).sum((1, 3)).flatten()
    dense = per > K1_TILE * K1_TILE // 4
    deg_note = f"degenerate pairs {deg or 'ok'}; " if degenerate else ""
    print(f"K1 on {what}, N = {n}, criteria 2, -1, 0, 1: max|kernel-plain| "
          f"{err:.3g} (tol {K1_ATOL}); near pairs {n_near} "
          f"({n_near / n / n:.4%}) (per {K1_TILE}x{K1_TILE} tile: mean "
          f"{float(per.float().mean()):.1f}, max {int(per.max())}; "
          f"{int(dense.sum())} of {per.numel()} tiles over a quarter near "
          f"hold {float(per[dense].sum() / per.sum().clamp(min=1)):.1%} of "
          f"them); culled pairs not +0.0: {bad}; {deg_note}output hashes "
          f"{sums}")
    if not err <= K1_ATOL or any(bad.values()) or deg:
        fail(f"K1 disagrees with its plain version on {what}")
    return dict(max_abs_err=err, n_near=n_near, checksums=sums)


# a near pair's full clipping: corners, 2 x 4 clipped edges; a pair's cull
# test: two differences, two squares, a sum, two adds, a square, a compare
K1_PAIR_OPS = 400
K1_CULL_OPS = 9
K1_TILE = 64            # boxes a side of a block's tile (riou_overlap.cu)


def k1_bound(n: int, m: int, n_near: int) -> dict:
    """K1's bound on [N, 5] x [M, 5] boxes: the boxes in, the matrix out;
    the cull test for every pair and the full clipping for the n_near
    pairs it keeps."""
    return bound((n + m) * 5 * 4 + n * m * 4,
                 n * m * K1_CULL_OPS + n_near * K1_PAIR_OPS)


def serving_split(torch, np, device, cfg, root: str):
    """Phase 6's inputs: a 4-scan synthetic KITTI val split written under
    root, its dataset, the serving step on `device` and the collated
    batches of one and of two scans."""
    import dataclasses
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.data import kitti, synthetic
    cfg_pts = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, device_input="points"))
    synthetic.write_synthetic_kitti(root, n_train=0, n_val=N_SCANS,
                                    seed=SEED)
    ds = kitti.KittiDataset(cfg, os.path.join(root, "training"),
                            os.path.join(root, "ImageSets", "val.txt"))
    view = serve.PointsView(ds, cfg_pts)
    step = serve.make_serving_step(cfg_pts, ds.anchors, ds.anchors_bv,
                                   device)
    batch1 = [kitti.collate([view[i]])[0] for i in range(N_SCANS)]
    batch2 = [kitti.collate([view[i], view[i + 1]])[0]
              for i in range(0, N_SCANS, 2)]
    return cfg_pts, ds, step, batch1, batch2


def serving_inputs(torch, np, device, cfg, model_dev):
    """The inputs of K1 and K3 in phase 6's first served car scan, captured
    in one serving step: the sorted boxes that rotate_nms hands to K1, and
    pswarp_score's part map, guided boxes, validity and arguments."""
    from sassd_tpu_torch.core import riou
    from sassd_tpu_torch.ops import warp
    seen, k3 = [], []
    orig, orig_k3 = riou.rotate_iou_bev, warp.pswarp_score

    def capture(a, b):
        seen.append(a.clone())
        return orig(a, b)

    def capture_k3(part_map, boxes, valid, *args):
        k3.append((part_map.clone(), boxes.clone(), valid.clone(), args))
        return orig_k3(part_map, boxes, valid, *args)
    with tempfile.TemporaryDirectory() as root:
        _, _, step, batch1, _ = serving_split(torch, np, device, cfg, root)
        riou.rotate_iou_bev, warp.pswarp_score = capture, capture_k3
        try:
            step(model_dev, batch1[0])
        finally:
            riou.rotate_iou_bev, warp.pswarp_score = orig, orig_k3
    torch.cuda.synchronize()
    return seen[0], k3[0]


def check_k3_serving(torch, k3_inputs) -> dict:
    """K3 at the serving shape: phase 6's first scan's part map and guided
    boxes (batch 1), under inference_mode as the serving step runs it (the
    mode entered once, as the step enters it)."""
    from sassd_tpu_torch.ops import warp
    part_map, boxes3, valid, args = k3_inputs
    b, k, h, w = part_map.shape
    n = boxes3.shape[1]

    def call():
        return warp.pswarp_score(part_map, boxes3, valid, *args)
    with torch.inference_mode():
        got = call()
        ref = warp.pswarp_score_plain(part_map, boxes3, valid, *args)
        err = float((got - ref).abs().max())
        n_valid = int(valid.sum())
        print(f"K3 pswarp_score at the serving shape {tuple(part_map.shape)} "
              f"x {n} boxes ({n_valid} valid): max|kernel-plain| = {err:.3g} "
              f"(tol {K3_ATOL})")
        if not err <= K3_ATOL:
            fail("K3 disagrees with its plain version at the serving shape")
        t = timed(call)
        plain_ms = cuda_ms(
            lambda: warp.pswarp_score_plain(part_map, boxes3, valid, *args),
            iters=5)
        print(f"  K3 serving b1: kernel {fmt_timed(t)}, plain "
              f"{plain_ms:.4f} ms; {fmt_split(call)}")
        print(f"  K3 serving b1 {host_split(call)[1]}")
    return dict(name="K3 pswarp_score, serving b1", route="cuda",
                source="sassd_tpu_torch/csrc/pswarp_score.cu",
                replaces="sassd_tpu/ops/warp.py:76", max_abs_err=err, **t,
                plain_ms=plain_ms, library_ms=None,
                library_what="none, as K3", n_valid=n_valid,
                at=f"phase 6's first scan, batch 1 x {n} guided boxes",
                **k3_bound(b, n, k))


def k3_bound(b: int, n: int, k: int) -> dict:
    """K3's bound: boxes, valid and scores, 4 map taps a part; ~70
    operations a part (lattice, sin/cos, 4 weights)."""
    return bound(b * n * (7 * 4 + 1 + 4) + b * n * k * 4 * 4, b * n * k * 70)


def check_nms_input(torch, riou_kernel, boxes) -> dict:
    """K1 at the NMS input of phase 6's first served car scan (criterion
    -1), checked as on the 2008-box set and timed."""
    k1 = k1_check(torch, riou_kernel, boxes, "phase 6's NMS input")
    t = timed(lambda: riou_kernel.rotate_overlap(boxes, boxes, -1))
    n = boxes.shape[0]
    print(f"  K1 at phase 6's NMS input, N = {n}, criterion -1: kernel "
          f"{fmt_timed(t)}; bound "
          f"{k1_bound(n, n, k1['n_near'])['bound_ms']:.4f} ms")
    return dict(nms_n=n, nms_n_near=k1["n_near"], nms_ms=t["ms"],
                nms_graph_ms=t["graph_ms"],
                nms_bound_ms=k1_bound(n, n, k1["n_near"])["bound_ms"],
                nms_checksums=k1["checksums"],
                max_abs_err=k1["max_abs_err"])


def check_kernels(torch, np, device):
    """Phase 3: each kernel against its plain version at path shapes."""
    from sassd_tpu_torch.core import riou
    from sassd_tpu_torch.ops import riou_kernel, warp

    rng = np.random.default_rng(SEED)
    rows = []
    # K1: 2000 x 2000 candidates + the degenerate set, raw areas
    boxes = np.concatenate([nms_boxes(rng, 2000),
                            np.asarray(DEGENERATE, np.float32)])
    bt = torch.from_numpy(boxes).to(device)
    k1 = k1_check(torch, riou_kernel, bt, "the 2008-box set",
                  degenerate=True)
    t1 = timed(lambda: riou_kernel.rotate_overlap(bt, bt, 2))
    plain_ms = cuda_ms(lambda: riou_kernel.rotate_overlap_plain(bt, bt, 2),
                       iters=5)
    print(f"  K1 {bt.shape[0]}^2, criterion 2: kernel {fmt_timed(t1)}, plain "
          f"{plain_ms:.4f} ms; "
          f"{fmt_split(lambda: riou_kernel.rotate_overlap(bt, bt, 2))}")
    rows.append(dict(name="K1 rotate_overlap", route="cuda",
                     source="sassd_tpu_torch/csrc/riou_overlap.cu",
                     replaces="sassd_tpu/ops/pallas/riou_kernel.py:137",
                     max_abs_err=k1["max_abs_err"], **t1,
                     plain_ms=plain_ms, library_ms=None,
                     library_what="none: torch has no rotated-box overlap",
                     at=f"{bt.shape[0]}^2 boxes, criterion 2",
                     n_near=k1["n_near"], checksums=k1["checksums"],
                     **k1_bound(bt.shape[0], bt.shape[0], k1["n_near"])))

    # K2: keep flags on the same boxes with random scores, then at sizes
    # around the sweep's 64-box blocks and its register words
    scores = torch.from_numpy(rng.uniform(0, 1, 2000).astype(np.float32))
    order = torch.argsort(-scores, stable=True).to(device)
    srt = bt[:2000][order].contiguous()
    iou = riou.rotate_iou_bev(srt, srt)
    keep0 = torch.from_numpy(rng.uniform(size=2000) < 0.95).to(device)
    rng2 = np.random.default_rng(SEED + 20)
    cases = [(iou, keep0)]
    for n2 in (1, 63, 64, 65, 2113):
        b2 = torch.from_numpy(nms_boxes(rng2, n2)).to(device)
        cases.append((riou.rotate_iou_bev(b2, b2), torch.from_numpy(
            rng2.uniform(size=n2) < 0.95).to(device)))
    err2 = 0
    for iou_c, keep0_c in cases:
        for thr in (0.1, 0.5):
            k_got = riou.nms_keep(iou_c, keep0_c, thr)
            k_ref = riou.nms_keep_plain(iou_c, keep0_c, thr)
            n_diff = int((k_got != k_ref).sum())
            err2 = max(err2, n_diff)
            print(f"K2 nms_keep N={keep0_c.shape[0]} thr={thr}: kept "
                  f"{int(k_got.sum())}, flags differing from plain greedy: "
                  f"{n_diff}")
    if err2:
        fail("K2 keep flags differ from the plain greedy")
    # the NMS path's threshold 0.1, and 0.5, where a 64-box block keeps
    # more boxes (K2's sweep follows the kept boxes)
    ms = cuda_ms(lambda: riou.nms_keep(iou, keep0, 0.1))
    dev_ms = graph_ms(lambda: riou.nms_keep(iou, keep0, 0.1))
    ms5 = cuda_ms(lambda: riou.nms_keep(iou, keep0, 0.5))
    dev_ms5 = graph_ms(lambda: riou.nms_keep(iou, keep0, 0.5))
    plain_ms = cuda_ms(lambda: riou.nms_keep_plain(iou, keep0, 0.1), iters=5)
    print(f"  K2 N=2000: kernel {ms:.4f} ms ({dev_ms:.4f} replayed from a "
          f"CUDA graph), plain {plain_ms:.4f} ms; at thr 0.5 {ms5:.4f} ms "
          f"({dev_ms5:.4f} replayed); "
          f"{fmt_split(lambda: riou.nms_keep(iou, keep0, 0.1))}")
    rows.append(dict(name="K2 nms_keep", route="cuda",
                     source="sassd_tpu_torch/csrc/rotate_nms.cu",
                     replaces="sassd_tpu/core/riou.py:188",
                     max_abs_err=float(err2), ms=ms, graph_ms=dev_ms,
                     thr05_ms=ms5, thr05_graph_ms=dev_ms5,
                     plain_ms=plain_ms, library_ms=None,
                     library_what="none: torch has no rotated NMS and no "
                                  "greedy keep over an IoU matrix",
                     at="N = 2000, thr 0.1",
                     # the upper triangle of the matrix and keep0 in, the
                     # flags out; a compare a pair
                     **bound(2000 * 1999 // 2 * 4 + 2 * 2000,
                             2000 * 1999 // 2)))

    # K3: [2, 28, 200, 176] part map, 2048 boxes per sample, ~10% off-map
    b, k, h, w, n = 2, 28, 200, 176, 2048
    part_map = torch.from_numpy(
        rng.normal(size=(b, k, h, w)).astype(np.float32)).to(device)
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0] = rng.uniform(0, 70.4, (b, n))
    bx[..., 1] = rng.uniform(-40, 40, (b, n))
    off = rng.uniform(size=(b, n)) < 0.1
    bx[..., 0][off] = rng.choice([-1.5, 71.5], off.sum())
    bx[..., 2] = -1.0
    bx[..., 3:6] = [1.6, 3.9, 1.56]
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    boxes3 = torch.from_numpy(bx).to(device)
    valid = torch.from_numpy(rng.uniform(size=(b, n)) < 0.9).to(device)
    args = ((4, 7), (0.0, 40.0), 1.0 / 0.4)
    got = warp.pswarp_score(part_map, boxes3, valid, *args)
    ref = warp.pswarp_score_plain(part_map, boxes3, valid, *args)
    err3 = float((got - ref).abs().max())
    print(f"K3 pswarp_score {tuple(part_map.shape)} x {n} boxes: "
          f"max|kernel-plain| = {err3:.3g} (tol {K3_ATOL})")
    if not err3 <= K3_ATOL:
        fail("K3 disagrees with its plain version")

    def k3():
        return warp.pswarp_score(part_map, boxes3, valid, *args)
    t3 = timed(k3)
    plain_ms = cuda_ms(
        lambda: warp.pswarp_score_plain(part_map, boxes3, valid, *args),
        iters=5)
    print(f"  K3 batch 2: kernel {fmt_timed(t3)}, plain {plain_ms:.4f} ms; "
          f"{fmt_split(k3)}")
    print(f"  K3 batch 2 {host_split(k3)[1]}")
    one = torch.zeros(1, device=device)
    print(f"  lone replay, not a kernel row: a one-element zero_ (the "
          f"replay harness's floor) {graph_ms(one.zero_):.4f} ms")
    rows.append(dict(name="K3 pswarp_score", route="cuda",
                     source="sassd_tpu_torch/csrc/pswarp_score.cu",
                     replaces="sassd_tpu/ops/warp.py:76",
                     max_abs_err=err3, **t3, plain_ms=plain_ms,
                     library_ms=None,
                     library_what="none: grid_sample samples every channel "
                                  "at every point; the part's channel and "
                                  "the mean take more calls",
                     at=f"batch 2 x {n} boxes", **k3_bound(b, n, k)))
    return rows


def check_sparse_kernels(torch, np, device, cfg, samples):
    """Phase 3, K4-K7, on the host plans of the car-config scans."""
    from sassd_tpu_torch.ops import sparse as sp

    rng = np.random.default_rng(SEED + 1)
    s0 = {k: torch.from_numpy(v[None]).to(device) for k, v in samples[0].items()}
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    rows = []

    # K4 at the ladder's 10 convs (7 distinct shapes), on the int16 wire
    # plans of scan 0 (batch 1)
    k4 = []
    for name, plan_key, level_in, cin, cout, mult in LADDER:
        feats = torch.from_numpy(rng.normal(
            size=(1, caps[level_in], cin)).astype(np.float32)).to(device)
        w = torch.from_numpy((rng.normal(size=(27, cin, cout))
                              / np.sqrt(27 * cin)).astype(np.float32)
                             ).to(device)
        plan = s0[plan_key]
        got = sp.subm_conv_batched(feats, w, plan)
        ref = sp.subm_conv_batched_plain(feats, w, plan)
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, rtol=K4_RTOL, atol=K4_ATOL))
        ms = cuda_ms(lambda: sp.subm_conv_batched(feats, w, plan))
        plain_ms = cuda_ms(lambda: sp.subm_conv_batched_plain(feats, w, plan))
        found = int((plan >= 0).sum())
        bd = bound(feats.numel() * 4 + plan.numel() * plan.element_size()
                   + w.numel() * 4 + plan.shape[2] * cout * 4,
                   2 * found * cin * cout)
        print(f"K4 sparse_conv {name} x{mult} {plan_key[5:]} "
              f"{tuple(plan.shape)} {cin}->{cout}: found slots "
              f"{found / plan.numel():.4f}; max|kernel-plain| = {err:.3g} "
              f"(rtol {K4_RTOL}, atol {K4_ATOL}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']})")
        if not ok:
            fail(f"K4 disagrees with its plain version on {name}")
        k4.append((name, mult, err, ms, plain_ms, found / plan.numel(), bd))
    rows.append(dict(name="K4 sparse_conv", route="cuda",
                     source="sassd_tpu_torch/csrc/sparse_conv.cu",
                     replaces="sassd_tpu/ops/sparse.py:411",
                     max_abs_err=max(e for _, _, e, *_ in k4),
                     ms=sum(n * m for _, n, _, m, *_ in k4),
                     plain_ms=sum(n * m for _, n, _, _, m, *_ in k4),
                     library_ms=None,
                     library_what="none: the 27 taps' row gather and the "
                                  "product are separate calls (conv3d is "
                                  "dense, not the submanifold function)",
                     at="batch 1, one scan's forward: the ladder's 10 convs,"
                        " launches x ms summed",
                     per_shape={name: dict(convs=n, ms=m, plain_ms=pm,
                                           found_frac=ff, **bd)
                                for name, n, _, m, pm, ff, bd in k4},
                     **add_bounds([bd for _, n, *_, bd in k4
                                   for _ in range(n)])))

    # K5: scan 0's level 3 (10240 rows x 64) into [1, 5*64, 200, 176]
    keys3 = sp.coords_to_keys(s0["plan_coords3"], shapes[3])
    x3 = torch.from_numpy(rng.normal(size=(1, caps[3], 64)).astype(
        np.float32)).to(device) * (keys3 != sp.INVALID_KEY)[..., None]
    canvas, occ = sp.densify_nchw(keys3, x3, shapes[3])
    ref_canvas, ref_occ = sp.densify_nchw_plain(keys3, x3, shapes[3])
    same5 = torch.equal(canvas, ref_canvas) and torch.equal(occ, ref_occ)
    err5 = float(max((canvas - ref_canvas).abs().max(),
                     (occ - ref_occ).abs().max()))
    ms = cuda_ms(lambda: sp.densify_nchw(keys3, x3, shapes[3]))
    dev5_ms = graph_ms(lambda: sp.densify_nchw(keys3, x3, shapes[3]))
    plain_ms = cuda_ms(lambda: sp.densify_nchw_plain(keys3, x3, shapes[3]))
    print(f"K5 densify {tuple(x3.shape)} -> {tuple(canvas.shape)}: "
          f"{'bitwise equal to' if same5 else 'DIFFERS from'} plain; "
          f"kernel {ms:.4f} ms ({dev5_ms:.4f} replayed from a CUDA graph), "
          f"plain {plain_ms:.4f} ms")
    if not same5:
        fail("K5 differs from its plain version")
    d3, h3, w3 = shapes[3]
    # the one-call yardstick: index_put_ of the active rows into a zeroed
    # [B, D, C, H, W] canvas (K5's canvas; its occupancy aside)
    bzyx = keys_bzyx(torch, keys3, shapes[3])
    rows3 = x3[keys3 != sp.INVALID_KEY]

    def put5():
        canvas = torch.zeros((1, d3, 64, h3, w3), device=device)
        canvas[bzyx[0], bzyx[1], :, bzyx[2], bzyx[3]] = rows3
    lib_ms = cuda_ms(put5)
    lib_graph_ms = graph_ms(put5)
    print(f"  K5 one-call yardstick (zeros + index_put_): {lib_ms:.4f} ms "
          f"({lib_graph_ms:.4f} replayed from a CUDA graph)")
    rows.append(dict(name="K5 densify", route="cuda",
                     source="sassd_tpu_torch/csrc/densify.cu",
                     replaces="sassd_tpu/ops/sparse.py:835",
                     max_abs_err=err5, ms=ms, graph_ms=dev5_ms,
                     plain_ms=plain_ms, library_ms=lib_ms,
                     library_graph_ms=lib_graph_ms,
                     library_what="torch.zeros + index_put_ of the rows "
                                  "into the NCHW canvas (no occupancy)",
                     # keys and rows in; the zeroed canvas and occupancy out
                     **bound(x3.numel() * 4 + keys3.numel() * 4
                             + canvas.numel() * 4 + occ.numel() * 4, 0)))

    # K6 + K7: the device rulebook of all scans as one batch, level by
    # level against the plain versions on the same inputs (the six plans in
    # one call of K6's plans), then the whole rulebook against the C++ host
    # rulebook
    coords0 = torch.from_numpy(np.stack([s["coords"] for s in samples]))
    keys = [sp.coords_to_keys(coords0.to(device), shapes[0])]
    err6 = err7 = 0.0
    dev_plans = {}
    for lvl in (1, 2, 3):
        out = sp.downsample_keys(keys[-1], shapes[lvl - 1], caps[lvl])
        ref = sp.downsample_keys_plain(keys[-1], shapes[lvl - 1], caps[lvl])
        err7 = max(err7, float((out - ref).abs().max()))
        dev_plans[f"coords{lvl}"] = sp.keys_to_coords(out, shapes[lvl])
        keys.append(out)
    maps = []
    for lvl in range(3):
        maps.append(sp.build_index_map(keys[lvl], shapes[lvl]))
        ref = sp.build_index_map_plain(keys[lvl], shapes[lvl])
        err6 = max(err6, float((maps[-1] - ref).abs().max()))
    del ref
    specs = sp.rulebook_specs(keys, shapes, maps)
    for name, plan, ref in zip(sp.RULEBOOK_PLANS, sp.window_plans(specs),
                               sp.window_plans_plain(specs)):
        err6 = max(err6, float((plan - ref).abs().max()))
        dev_plans[name] = plan
    del maps, specs
    host_diff = {}
    for k, v in dev_plans.items():
        host = np.stack([s[f"plan_{k}"] for s in samples]).astype(np.int32)
        n = int((v.cpu().numpy() != host).sum())
        if n:
            host_diff[k] = n
    print(f"K6 index maps + window plans (the six in one call), K7 "
          f"downsample, {len(samples)} "
          f"scans: max|kernel-plain| K6 {err6:g}, K7 {err7:g}; entries "
          f"differing from the C++ host rulebook (subm0-2, stride1-3, "
          f"coords1-3): {host_diff or 'none'}")
    if err6 or err7 or host_diff:
        fail("the device rulebook differs from its plain version or the "
             "host rulebook")

    keys0 = sp.coords_to_keys(s0["coords"], shapes[0])

    def k6(fn_map, fn_plan):
        imap = fn_map(keys0, shapes[0])
        return fn_plan(keys0, shapes[0], imap, shapes[0], 1)
    ms = cuda_ms(lambda: k6(sp.build_index_map, sp.window_plan))
    plain_ms = cuda_ms(lambda: k6(sp.build_index_map_plain,
                                  sp.window_plan_plain))
    m0 = keys0.shape[1]
    total0 = shapes[0][0] * shapes[0][1] * shapes[0][2]
    # the map alone beside one torch.full + index_put_ of the valid rows
    map_ms = cuda_ms(lambda: sp.build_index_map(keys0, shapes[0]))
    ok0 = keys0[0] != sp.INVALID_KEY
    key_idx = keys0[0][ok0].long()
    row_vals = torch.nonzero(ok0)[:, 0].to(torch.int32)

    def put6():
        imap = torch.full((total0,), -1, dtype=torch.int32, device=device)
        imap.index_put_((key_idx,), row_vals)
    lib6_ms = cuda_ms(put6)
    map_graph_ms = graph_ms(lambda: sp.build_index_map(keys0, shapes[0]))
    lib6_graph_ms = graph_ms(put6)
    print(f"  K6 L0 map + subm0 plan (batch 1): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; the map alone {map_ms:.4f} ms "
          f"({map_graph_ms:.4f} replayed from a CUDA graph), one-call "
          f"yardstick (full + index_put_) {lib6_ms:.4f} ms "
          f"({lib6_graph_ms:.4f} replayed)")
    # the map's two replay modes: the map and its yardstick in turns (map,
    # yardstick, yardstick, map), each turn three graphs of 50 replays
    turns = []
    for what, fn in (("map", lambda: sp.build_index_map(keys0, shapes[0])),
                     ("yardstick", put6), ("yardstick", put6),
                     ("map", lambda: sp.build_index_map(keys0, shapes[0]))):
        turns.append((what, [graph_ms(fn, iters=50) for _ in range(3)]))
    print("  K6 L0 map against its yardstick in turns, replayed: "
          + "; ".join(f"{w} {', '.join(f'{t:.4f}' for t in ts)}"
                      for w, ts in turns))
    # K6's other launches of a train step at batch 1: the maps of levels
    # 1-3 and each plan alone (a window_plan call, one launch), each by
    # torch.profiler's device time a call (its map's memset included)
    # beside its bound: keys in, a map written whole, a plan written whole
    # with 27 map reads a valid row
    lk = [keys0]
    for lvl in (1, 2, 3):
        lk.append(sp.downsample_keys(lk[-1], shapes[lvl - 1], caps[lvl]))
    lmaps = [sp.build_index_map(k, sh) for k, sh in zip(lk, shapes)]
    specs = sp.rulebook_specs(lk, shapes, lmaps)
    plan_bds = [k6_plan_bound(spec[0]) for spec in specs]
    parts = {}
    for lvl in (1, 2, 3):
        m = lk[lvl].shape[1]
        total = shapes[lvl][0] * shapes[lvl][1] * shapes[lvl][2]
        parts[f"L{lvl} map"] = (
            lambda lvl=lvl: sp.build_index_map(lk[lvl], shapes[lvl]),
            bound(m * 4 + total * 4, 0))
    for name, spec, bd in zip(sp.RULEBOOK_PLANS, specs, plan_bds):
        parts[f"{name} plan"] = (lambda spec=spec: sp.window_plan(*spec), bd)
    k6_parts = {}
    for what, (fn, bd) in parts.items():
        split = kernel_split(fn)
        prof = sum(split.values()) if split else None
        k6_parts[what] = dict(profiler_ms=prof, kernel_split=split,
                              bound_ms=bd["bound_ms"],
                              bound_bytes=bd["bound_bytes"])
    print("  K6's other launches, batch 1, each plan alone (profiler ms a "
          "call / bound ms): "
          + "; ".join(f"{w} " + ("not measured" if v["profiler_ms"] is None
                                 else f"{v['profiler_ms']:.4f}")
                      + f" / {v['bound_ms']:.4f}"
                      for w, v in k6_parts.items()))
    plans = k6_plans_timed(torch, sp, specs, plan_bds)
    del lmaps, specs
    rows.append(dict(name="K6 device_plans", route="cuda",
                     source="sassd_tpu_torch/csrc/device_plans.cu",
                     replaces="sassd_tpu/ops/sparse.py:84",
                     max_abs_err=err6, ms=ms, plain_ms=plain_ms,
                     map_ms=map_ms, map_graph_ms=map_graph_ms,
                     map_turns_graph_ms=turns, other_launches=k6_parts,
                     plans=plans,
                     library_ms=lib6_ms, library_graph_ms=lib6_graph_ms,
                     library_what="torch.full(-1) + index_put_ of the valid "
                                  "rows: the L0 map alone, against map_ms; "
                                  "the six plans (plans) have none: the "
                                  "window's tap cells and edge masks take "
                                  "several calls before a torch.take",
                     at="L0 index map + subm0 plan, batch 1; plans: the "
                        "six plans of a scan in one call, batch 1",
                     # keys in, the whole map written, 27 map reads and
                     # one plan entry out per row and tap
                     **bound(m0 * 4 + total0 * 4 + 2 * 27 * m0 * 4, 0)))
    rows.append(k7_row(torch, sp, keys0, shapes[0], caps[1], err7,
                       "K7 downsample", "L0 -> L1, batch 1, the car scan"))
    return rows


def k6_plan_bound(out_keys) -> dict:
    """A plan's bound: its keys read, the [B, 27, M_out] plan written, and
    27 map reads of 4 bytes a valid row."""
    from sassd_tpu_torch.ops import sparse as sp
    m = out_keys.numel()
    n = int((out_keys != sp.INVALID_KEY).sum())
    return bound(m * 4 + 27 * m * 4 + 27 * n * 4, 0)


def k6_plans_timed(torch, sp, specs, plan_bds) -> dict:
    """K6's plans of a scan in one window_plans call, read four ways
    (measured), beside the plain version; their bound is the six plans'
    summed."""
    t = measured(lambda: sp.window_plans(specs), "K6's six plans, one call")
    plain_ms = cuda_ms(lambda: sp.window_plans_plain(specs), iters=5)
    bd = add_bounds(plan_bds)
    print(f"  K6's six plans, one call: kernel {t['ms']:.4f} ms "
          f"({t['graph_ms']:.4f} replayed, profiler "
          + ("not measured" if t["profiler_ms"] is None
             else f"{t['profiler_ms']:.4f}")
          + f", host {t['host_us']:.1f} us), plain {plain_ms:.4f} ms; bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    return dict(**t, plain_ms=plain_ms, library_ms=None, **bd)


def k7_row(torch, sp, keys, shape, cap, err, name, at, y_limit=None):
    """K7's kernel row: the whole op (K7 on the card) against its plain
    version and, on one row, torch.unique of its candidates (one call,
    sorted: the same set before the cap), on [B, M] keys."""
    ms = cuda_ms(lambda: sp.downsample_keys(keys, shape, cap, y_limit))
    dev_ms = graph_ms(lambda: sp.downsample_keys(keys, shape, cap, y_limit))
    plain_ms = cuda_ms(lambda: sp.downsample_keys_plain(keys, shape, cap,
                                                        y_limit))
    b = keys.shape[0]
    cands = sp.downsample_candidates(keys, shape, y_limit)
    if b == 1:
        cands = cands[0]
    else:
        # rows apart: each row's candidates offset by row * 2^31 (int64)
        cands = cands.to(torch.int64) + (torch.arange(
            b, device=keys.device)[:, None] << 31)
    lib_ms = cuda_ms(lambda: torch.unique(cands))
    print(f"  {name} ({at}): kernel {ms:.4f} ms ({dev_ms:.4f} replayed from "
          f"a CUDA graph), plain {plain_ms:.4f} ms; torch.unique of the "
          f"{8 * keys.numel()} candidates {lib_ms:.4f} ms")
    return dict(name=name, route="cuda",
                source="sassd_tpu_torch/csrc/downsample.cu",
                replaces="sassd_tpu/ops/sparse.py:618" if y_limit is None
                else "sassd_tpu/ops/sparse.py:590",
                max_abs_err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                library_ms=lib_ms,
                # torch.unique reads its output's size back to the host,
                # which a CUDA graph cannot capture
                library_graph_ms=None,
                library_what="torch.unique of the candidates (sorted, "
                             "uncapped; rows apart by an offset of row x "
                             "2^31 past batch 1)",
                at=at,
                # the function's bytes: keys (and limits) in, the capped
                # levels out; 8 parent keys a row
                **bound(keys.numel() * 4 + b * cap * 4
                        + (0 if y_limit is None else b * 4),
                        8 * keys.numel()))


def voxel_keys(torch, points, n_points, vc):
    """[B, P] int32 voxel keys of padded points, INVALID_KEY where a point
    is padding or off the grid: the keys the parent design sorted."""
    dev = points.device
    pcr = torch.tensor(vc.point_cloud_range[:3], dtype=torch.float32,
                       device=dev)
    vs = torch.tensor(vc.voxel_size, dtype=torch.float32, device=dev)
    c = torch.floor((points[..., :3] - pcr) / vs).to(torch.int32)
    gx, gy, gz = (int(g) for g in vc.grid_size)
    ok = ((torch.arange(points.shape[1], device=dev)[None]
           < n_points[:, None])
          & ((c >= 0) & (c < torch.tensor([gx, gy, gz], dtype=torch.int32,
                                          device=dev))).all(-1))
    return torch.where(ok, (c[..., 2] * gy + c[..., 1]) * gx + c[..., 0],
                       torch.iinfo(torch.int32).max)


def k8_row(torch, vox, pts, n, vc, err, name, at, extra=None):
    """K8's kernel row on [1, P] points: the whole op against its plain
    version, as events and as a graph replay (its parts by kernel printed
    as a diagnostic), and the parent design's torch.sort of the same keys alone (a component of
    the old design, not a yardstick: it is not the function)."""
    fn = lambda: vox.voxelize(pts, n, vc)                      # noqa: E731
    ms = cuda_ms(fn)
    dev_ms = graph_ms(fn)
    plain_ms = cuda_ms(lambda: vox.voxelize_plain(pts, n, vc))
    keys = voxel_keys(torch, pts, n, vc)
    sort_ms = cuda_ms(lambda: torch.sort(keys, dim=1, stable=True))
    n_in = int(n.sum())
    print(f"  {name} ({at}): kernel {ms:.4f} ms ({dev_ms:.4f} replayed "
          f"from a CUDA graph), plain {plain_ms:.4f} ms; the old design's "
          f"torch.sort of the keys alone {sort_ms:.4f} ms; {fmt_split(fn)}")
    return dict(name=name, route="cuda",
                source="sassd_tpu_torch/csrc/voxelize.cu",
                replaces="sassd_tpu/ops/voxelize.py:142",
                max_abs_err=err, ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                library_ms=None,
                library_what="none: no PyTorch call voxelizes",
                sort_ms=sort_ms, at=at, **(extra or {}),
                # the valid points in; voxels, coords and counts out; the
                # quantisation's 9 float32 operations a point
                **bound(n_in * pts.shape[2] * 4 + vc.max_voxels * (
                    vc.max_num_points * pts.shape[2] * 4 + 12 + 4),
                    9 * n_in))


def check_serving_kernels(torch, np, device, cfg, scans, anchors_bv):
    """Phase 3, K8 and K9: the device voxelizer and the anchors mask of
    raw car-config scans against their plain versions on the card; K8 also
    on a batch of two with one sample empty and on phase 9's long-range
    timing scan, K9 also on the three-class corner table."""
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.config import long_range_config, multi_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.ops import voxelize as vox

    prepared = [serve.prepare_points(p, cfg) for p in scans]
    pts = torch.from_numpy(np.stack([p for p, _ in prepared])).to(device)
    n = torch.from_numpy(np.asarray([k for _, k in prepared],
                                    np.int32)).to(device)
    lr = long_range_config()
    lr_pts, lr_n = serve.prepare_points(synthetic.long_range_scene(
        np.random.default_rng(SEED + 10))[0], lr)
    lr_pts = torch.from_numpy(lr_pts[None]).to(device)
    lr_n = torch.from_numpy(np.asarray([lr_n], np.int32)).to(device)
    n_empty = n[:2].clone()
    n_empty[1] = 0
    err8 = 0.0
    for what, p8, n8, vc in (
            (f"car scans at the {cfg.voxel.max_voxels}-voxel cap and a "
             f"frustum scan", pts, n, cfg.voxel),
            ("a batch of two, the second sample empty", pts[:2], n_empty,
             cfg.voxel),
            ("the long-range timing scan", lr_pts, lr_n, lr.voxel)):
        got = vox.voxelize(p8, n8, vc)
        ref = vox.voxelize_plain(p8, n8, vc)
        same8 = all(torch.equal(a, b) for a, b in zip(got, ref))
        err8 = max(err8, float(max((a.double() - b.double()).abs().max()
                                   for a, b in zip(got, ref))))
        n_vox = (got[1][..., 0] >= 0).sum(1).tolist()
        print(f"K8 voxelize, {what}, {tuple(p8.shape)}, n_points "
              f"{n8.tolist()}: {'bitwise equal to' if same8 else 'DIFFERS from'}"
              f" plain; voxels {n_vox} (cap {vc.max_voxels})")
        if not same8:
            fail(f"K8 differs from its plain version on {what}")
        if p8 is pts:
            coords8 = got[1]
    hw = (int(cfg.voxel.grid_size[1]), int(cfg.voxel.grid_size[0]))
    thr = cfg.data.anchor_area_threshold
    multi = multi_config()
    err9 = 0.0
    for what, cfg9, bv in (("car", cfg, anchors_bv),
                           ("three-class", multi,
                            kitti.build_anchors(multi)[1])):
        corners = serve.anchor_corner_indices(
            bv, cfg9.voxel.voxel_size, cfg9.voxel.point_cloud_range,
            cfg9.voxel.grid_size)
        lat = serve.anchor_lattice(corners, hw).to(device)
        for c in (coords8[:1], coords8[:2], coords8):
            mask = serve.anchors_mask(c, lat, thr)
            mask_ref = serve.anchors_mask_plain(c, lat.corners, hw, thr)
            same9 = torch.equal(mask, mask_ref)
            err9 = max(err9, float((mask.int() - mask_ref.int()).abs().max()))
            print(f"K9 anchors_mask, {what} corner table "
                  f"({corners.shape[0]} anchors, lattice {lat.shape}), "
                  f"coords {tuple(c.shape)} over a {hw[0]}x{hw[1]} grid: "
                  f"{'bitwise equal to' if same9 else 'DIFFERS from'} plain; "
                  f"anchors kept {mask.sum(1).tolist()}")
            if not same9:
                fail(f"K9 differs from its plain version ({what})")
        if what == "car":
            car = lat

    p1, n1, c1 = pts[:1], n[:1], coords8[:1].contiguous()
    p2, n2 = pts[:2], n[:2]
    b2_ms = cuda_ms(lambda: vox.voxelize(p2, n2, cfg.voxel))
    b2_graph_ms = graph_ms(lambda: vox.voxelize(p2, n2, cfg.voxel))
    print(f"  K8 batch 2 (car scans 0-1): kernel {b2_ms:.4f} ms "
          f"({b2_graph_ms:.4f} replayed from a CUDA graph)")
    rows = [k8_row(torch, vox, p1, n1, cfg.voxel, err8, "K8 voxelize",
                   "batch 1 car scan, 65,536-point cap",
                   dict(batch2_ms=b2_ms, batch2_graph_ms=b2_graph_ms)),
            k8_row(torch, vox, lr_pts, lr_n, lr.voxel, err8,
                   "K8 voxelize, long range",
                   "batch 1, phase 9's long-range timing scan, "
                   "262,144-point cap, 80,000 voxels")]
    lat, ct = car, car.corners

    def k9(c):
        return serve.anchors_mask(c, lat, thr)

    c2 = coords8[:2].contiguous()
    t1 = timed(lambda: k9(c1))
    t2 = timed(lambda: k9(c2))
    # all but the scatter: the call on no voxels
    none_ms = graph_ms(lambda: k9(c1[:, :0]))
    plain_ms = cuda_ms(lambda: serve.anchors_mask_plain(c1, ct, hw, thr))
    n_anchors = ct.shape[0]
    # an estimate, printed only: the design's floor, which adds the
    # lattice written once and read once to the function's bytes
    cells = lat.shape[0] * lat.shape[1]
    floor_ms = bound(c1.shape[1] * 12 + n_anchors * 17 + 2 * cells * 4,
                     0)["bound_ms"]
    print(f"  K9 car batch 1: kernel {fmt_timed(t1)}, plain {plain_ms:.4f} "
          f"ms; batch 2 {fmt_timed(t2)}; on no voxels (all but the "
          f"scatter) {none_ms:.4f} replayed (a call replayed alone reads "
          f"0.008-0.015 ms even for a memset); lattice design floor "
          f"(estimate, not the bound) {floor_ms:.4f} ms; "
          f"{fmt_split(lambda: k9(c1))}")
    rows.append(dict(name="K9 anchors_mask", route="cuda",
                     source="sassd_tpu_torch/csrc/anchors_mask.cu",
                     replaces="sassd_tpu/serve.py:106",
                     max_abs_err=err9, **t1, batch2_ms=t2["ms"],
                     batch2_graph_ms=t2["graph_ms"],
                     no_voxels_graph_ms=none_ms, plain_ms=plain_ms,
                     library_ms=None,
                     library_what="none: the occupancy scatter, two "
                                  "cumsums and the corner reads are "
                                  "separate calls",
                     at="batch 1, 20,000 voxels, 70,400 anchors",
                     # coords and corner indices in, the mask out
                     **bound(c1.shape[1] * 12 + n_anchors * 17,
                             c1.shape[1] + 4 * n_anchors)))
    return rows


def ring_interp_level(torch, what, query, cell0, level, feats, plan, vs, pc,
                      cot) -> dict:
    """K11 at one level: rows, weights and output bitwise its plain
    version's (the signs of zeros included), the feature gradient within
    TRAIN_GRAD_RTOL of autograd through the plain version. Timed by
    events and graph replay, each in its own graph: the forward (one
    kernel), the backward (its memset of d_feats and its kernel), that
    memset alone (the backward called with no query) and the zeroing as
    the parent wrapper made it (torch.zeros); forward + backward replayed
    from one graph; the plain version; index_add_, the backward's one-call
    yardstick. Bounds: a padded query (cell z < 0)
    reads its cell and writes its output row and its rows and weights; a
    valid one also reads its point and its plan, and in the backward its
    d_out row and its rows and weights; each selected feature row is read
    once, d_feats written once."""
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops.cuda import same_bits
    b, m, c = feats.shape
    args = (query, cell0, level, feats, plan, vs, pc)
    out, rsel, wsel = itp.ring_interp_fwd(*args)
    ref_rows, ref_w = itp.ring_select_plain(query, cell0, level, plan, m, vs,
                                            pc)
    same = (torch.equal(rsel.long(), ref_rows)
            and same_bits(wsel, ref_w)
            and same_bits(out,
                          itp.neighborhood_interpolate_cells_plain(*args)))
    fk = feats.clone().requires_grad_()
    itp.neighborhood_interpolate_cells(query, cell0, level, fk, plan, vs,
                                       pc).backward(cot)
    fp = feats.clone().requires_grad_()
    out_p = itp.neighborhood_interpolate_cells_plain(query, cell0, level, fp,
                                                     plan, vs, pc)
    err = rel_err(fk.grad, torch.autograd.grad(out_p, fp, cot,
                                               retain_graph=True)[0])
    valid = cell0[..., 0] >= 0
    q_v, q_p = int(valid.sum()), int((~valid).sum())
    print(f"K11 ring_interp{what} level {level} {tuple(query.shape)} -> "
          f"{tuple(out.shape)}, {q_p} padded queries: forward, rows and "
          f"weights {'bitwise equal to' if same else 'DIFFER from'} plain; "
          f"backward rel err {err:.3g} (tol {TRAIN_GRAD_RTOL})")
    if not same or err > TRAIN_GRAD_RTOL:
        fail(f"K11{what} disagrees with its plain version at level {level}")

    def fwd():
        return itp.ring_interp_fwd(*args)

    def bwd():
        return itp.ring_interp_bwd(cot, rsel, wsel, feats.shape)

    def both():
        _, r, w = fwd()
        return itp.ring_interp_bwd(cot, r, w, feats.shape)

    def zero():
        return torch.zeros(feats.shape, device=feats.device)

    def memset():                           # the backward with no query
        return itp.ring_interp_bwd(cot[:, :0], rsel[:0], wsel[:0],
                                   feats.shape)
    both_graph = graph_ms(both)
    t_fwd, t_bwd, t_zero = timed(fwd), timed(bwd), timed(zero)
    t_set = timed(memset)
    plain_ms = grad_ms(out_p, fp, cot) + cuda_ms(
        lambda: itp.neighborhood_interpolate_cells_plain(*args))
    src = (cot[:, :, None] * wsel.view(b, -1, 3, 1)).reshape(-1, c)
    flat = torch.zeros((b * m, c), device=feats.device)
    lib_ms = cuda_ms(lambda: flat.index_add_(0, rsel.view(-1).long(), src))
    n_rows = int(torch.unique(rsel).numel())
    org = pc.numel() * 4 if torch.is_tensor(pc) else 0
    # 17 float32 operations a tap's distance, 5 a channel of the sum; 6 a
    # channel of the backward
    bd_fwd = bound(q_v * (24 + 27 * plan.element_size() + 4 * c + 24)
                   + q_p * (12 + 4 * c + 24) + n_rows * c * 4 + org,
                   q_v * 27 * 17 + (q_v + q_p) * 5 * c)
    bd_bwd = bound(q_v * (4 * c + 24) + feats.numel() * 4, q_v * 6 * c)
    bd_zero = bound(feats.numel() * 4, 0)
    print(f"  K11{what} level {level}: forward {fmt_timed(t_fwd)}, bound "
          f"{bd_fwd['bound_ms']:.4f}; backward {fmt_timed(t_bwd)}, bound "
          f"{bd_bwd['bound_ms']:.4f}, of which its memset alone "
          f"{fmt_timed(t_set)}; zeroing as the parent made it (torch.zeros) "
          f"{fmt_timed(t_zero)}; zeroing bound {bd_zero['bound_ms']:.4f}; "
          f"forward + backward replayed {both_graph:.4f} ms; plain "
          f"{plain_ms:.4f} ms; index_add_ (backward) {lib_ms:.4f} ms")
    print(f"    forward {fmt_split(fwd)}; backward {fmt_split(bwd)}")
    return dict(err=err, ms=t_fwd["ms"] + t_bwd["ms"], graph_ms=both_graph,
                plain_ms=plain_ms, library_backward_ms=lib_ms, queries=q_v,
                padded_queries=q_p, forward=dict(**t_fwd, **bd_fwd),
                backward=dict(**t_bwd, **bd_bwd), memset=dict(**t_set,
                                                              **bd_zero),
                zeroing_torch=dict(**t_zero, **bd_zero),
                **add_bounds([bd_fwd, bd_bwd]))


def ring_interp_row(levels: dict, name: str, replaces: str, at: str) -> dict:
    """The kernel row of K11 (or K11') from ring_interp_level's results:
    ms by events (forward + backward), graph_ms replayed (the same, one
    graph a level), summed over the levels."""
    return dict(name=name, route="cuda",
                source="sassd_tpu_torch/csrc/interpolate.cu",
                replaces=replaces,
                max_abs_err=max(d["err"] for d in levels.values()),
                err_kind="backward, relative to max |plain|; the forward is "
                         "bitwise",
                ms=sum(d["ms"] for d in levels.values()),
                graph_ms=sum(d["graph_ms"] for d in levels.values()),
                plain_ms=sum(d["plain_ms"] for d in levels.values()),
                library_ms=None,
                library_what="none for the forward (the 27-tap selection "
                             "takes several calls); index_add_ of the "
                             "weighted d_out rows for the backward alone "
                             "(library_backward_ms)",
                library_backward_ms=sum(d["library_backward_ms"]
                                        for d in levels.values()),
                at=f"{at}, forward + backward (with the d_feats zeroing)",
                per_level={lv: {k: v for k, v in d.items() if k != "err"}
                           for lv, d in levels.items()},
                **add_bounds(list(levels.values())))


def k3b_check(torch, what, part_map, boxes3, valid, d_score, args):
    """K3b on one set of inputs: within TRAIN_GRAD_RTOL of autograd of the
    plain version, and d_map and d_boxes bitwise equal over two calls.
    Returns the error and the plain version's leaves and output."""
    from sassd_tpu_torch.ops import warp
    from sassd_tpu_torch.ops.cuda import same_bits
    d_map, d_boxes = warp.pswarp_score_grad(part_map, boxes3, valid, d_score,
                                            *args)
    again = warp.pswarp_score_grad(part_map, boxes3, valid, d_score, *args)
    pm, pb = part_map.clone().requires_grad_(), boxes3.clone(
        ).requires_grad_()
    out_p = warp.pswarp_score_plain(pm, pb, valid, *args)
    ref_map, ref_boxes = torch.autograd.grad(out_p, (pm, pb), d_score,
                                             retain_graph=True)
    err_map, err_boxes = rel_err(d_map, ref_map), rel_err(d_boxes, ref_boxes)
    same = same_bits(again[0], d_map) and same_bits(again[1], d_boxes)
    print(f"K3b pswarp_score_grad on {what}, {tuple(part_map.shape)} x "
          f"{boxes3.shape[1]} boxes ({int(valid.sum())} valid): rel err map "
          f"{err_map:.3g}, boxes {err_boxes:.3g} (tol {TRAIN_GRAD_RTOL}); "
          f"two calls {'bitwise equal' if same else 'DIFFER'}")
    if not max(err_map, err_boxes) <= TRAIN_GRAD_RTOL:
        fail(f"K3b disagrees with autograd of the plain version on {what}")
    if not same:
        fail(f"K3b: two calls on {what} differ")
    return max(err_map, err_boxes), (pm, pb, out_p)


def k12_check(torch, what, query, pvalid, gt, gv):
    """K12 against its plain version on the same inputs, bitwise (labels
    and offsets); fails otherwise. Returns the kernel's (label, offsets)
    and the offsets' largest absolute difference from the plain version's."""
    from sassd_tpu_torch.core import boxes
    from sassd_tpu_torch.ops.cuda import same_bits
    label, off = boxes.aux_targets(query, pvalid, gt, gv)
    ref_label, ref_off = boxes.aux_targets_plain(query, pvalid, gt, gv)
    same = torch.equal(label, ref_label) and same_bits(off, ref_off)
    print(f"K12 aux_targets on {what}, {tuple(query.shape)} x "
          f"{tuple(gt.shape)} ({int(gv.sum())} valid boxes): "
          f"{'bitwise equal to' if same else 'DIFFERS from'} plain")
    if not same:
        fail(f"K12 differs from its plain version on {what}")
    return label, off, float((off - ref_off).abs().max())


def k12_bound(torch, query, pvalid, gt, gv, label, off) -> dict:
    """K12's bound: points, validity, boxes and slots read once, labels and
    offsets written once; operations: 15 a point-box test (two
    differences, the rotation's four products and two sums, three
    absolute values and compares, the z difference) over the pairs this
    run's data tests (a valid point walks the valid boxes up to its first
    hit), and 40 a valid box for its sine and cosine."""
    from sassd_tpu_torch.core import boxes
    flags = (boxes.points_in_boxes3d(query, gt)[0] & gv[:, None, :]
             & pvalid[..., None])
    rank = torch.cumsum(gv.to(torch.int64), 1)          # 1-based among valid
    first = torch.argmax(flags.to(torch.uint8), -1)
    tested = torch.where(flags.any(-1), torch.gather(rank, 1, first),
                         rank[:, -1:].expand_as(first))
    pairs = int(tested[pvalid].sum())
    return dict(**bound(query.numel() * 4 + pvalid.numel() + gt.numel() * 4
                        + gv.numel() + label.numel() + off.numel() * 4,
                        15 * pairs + 40 * int(gv.sum())),
                pairs_tested=pairs)


def check_train_kernels(torch, np, device, cfg, samples, gts):
    """Phase 3, the training kernels at batch 2 on the train plans of the
    first two car scans: K10 and K4's input gradients, K11, K12, K3b, K5b.
    gts: [2, max_gt, 7] GT boxes and [2, max_gt] validity (the scenes')."""
    from sassd_tpu_torch.core import boxes
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.ops import warp

    rng = np.random.default_rng(SEED + 4)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples[:2]])).to(
        device) for k in samples[0] if k != "meta"}
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(device)
    rows = []

    # K10, and K4 as the input gradient, at the ladder's 10 convs (7
    # distinct shapes; the first conv's input takes no gradient): K4 runs
    # the subm plan with the tap-reversed transposed weights, or the stride
    # conv's transpose plan with the transposed weights
    k10, k4dx = [], []
    for name, plan_key, level_in, cin, cout, mult in LADDER:
        plan = batch[plan_key]
        x = randn(2, caps[level_in], cin)
        w = randn(27, cin, cout, scale=1 / np.sqrt(27 * cin))
        cot = randn(2, plan.shape[2], cout)
        dw = sp.conv_weight_grad(x, plan, cot)
        dw2 = sp.conv_weight_grad(x, plan, cot)
        dw_ref = sp.conv_weight_grad_plain(x, plan, cot)
        err = rel_err(dw, dw_ref)
        if not torch.equal(dw, dw2):
            fail(f"K10 gives two different weight gradients on {name}")
        ms = cuda_ms(lambda: sp.conv_weight_grad(x, plan, cot))
        plain_ms = cuda_ms(lambda: sp.conv_weight_grad_plain(x, plan, cot))
        found = int((plan >= 0).sum())
        bd = bound(x.numel() * 4 + cot.numel() * 4
                   + plan.numel() * plan.element_size() + dw.numel() * 4,
                   2 * found * cin * cout)
        print(f"K10 conv_weight_grad {name} x{mult} {plan_key[5:]} "
              f"{cin}->{cout} {tuple(plan.shape)}: found slots "
              f"{found / plan.numel():.4f}; rel err {err:.3g} (tol "
              f"{TRAIN_GRAD_RTOL}), two calls bitwise equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        if not err <= TRAIN_GRAD_RTOL:
            fail(f"K10 disagrees with its plain version on {name}")
        k10.append((name, mult, err, ms, plain_ms, found / plan.numel(), bd))
        if cin == 4:
            continue
        if plan_key.startswith("plan_subm"):
            fn, args = sp.subm_conv_sym, (plan,)
            dx_plan = plan
            w_dx = w.flip(0).transpose(1, 2).contiguous()
        else:
            dx_plan = batch["plan_strideT" + plan_key[-1]]
            fn, args = sp.stride_conv_hostT, (plan, dx_plan)
            w_dx = w.transpose(1, 2).contiguous()
        xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        fn(xk, w, *args).backward(cot)
        sp.subm_conv_batched_plain(xp, w, plan).backward(cot)
        dx_err = rel_err(xk.grad, xp.grad)
        ms = cuda_ms(lambda: sp.subm_conv_batched(cot, w_dx, dx_plan))
        plain_ms = cuda_ms(lambda: sp.subm_conv_batched_plain(cot, w_dx,
                                                              dx_plan))
        found = int((dx_plan >= 0).sum())
        bd = bound(cot.numel() * 4 + dx_plan.numel() * dx_plan.element_size()
                   + w_dx.numel() * 4 + x.numel() * 4,
                   2 * found * cin * cout)
        print(f"  K4 input gradient {name} x{mult} on "
              f"{'the subm plan' if dx_plan is plan else 'strideT'} "
              f"{tuple(dx_plan.shape)} {cout}->{cin}: found slots "
              f"{found / dx_plan.numel():.4f}; rel err {dx_err:.3g} (tol "
              f"{TRAIN_GRAD_RTOL}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']})")
        if not dx_err <= TRAIN_GRAD_RTOL:
            fail(f"K4's input gradient disagrees on {name}")
        k4dx.append((name, mult, dx_err, ms, plain_ms,
                     found / dx_plan.numel(), bd))
    rows.append(dict(name="K10 conv_weight_grad", route="cuda",
                     source="sassd_tpu_torch/csrc/sparse_conv_bwd.cu",
                     replaces="sassd_tpu/ops/sparse.py:541",
                     max_abs_err=max(e for _, _, e, *_ in k10),
                     err_kind="relative to max |plain|; two calls bitwise "
                              "equal",
                     ms=sum(n * m for _, n, _, m, *_ in k10),
                     plain_ms=sum(n * m for _, n, _, _, m, *_ in k10),
                     library_ms=None,
                     library_what="none: each tap's row gathers and its "
                                  "product are separate calls",
                     at="batch 2, one train step's weight gradients: the "
                        "ladder's 10 convs, launches x ms summed",
                     per_shape={name: dict(convs=n, ms=m, plain_ms=pm,
                                           found_frac=ff, **bd)
                                for name, n, _, m, pm, ff, bd in k10},
                     input_grad=dict(
                         kernel="K4", max_rel_err=max(e for _, _, e, *_
                                                      in k4dx),
                         ms=sum(n * m for _, n, _, m, *_ in k4dx),
                         plain_ms=sum(n * m for _, n, _, _, m, *_ in k4dx),
                         at="batch 2, the 9 convs whose input takes a "
                            "gradient, launches x ms summed",
                         per_shape={name: dict(convs=n, ms=m, plain_ms=pm,
                                               found_frac=ff, **bd)
                                    for name, n, _, m, pm, ff, bd in k4dx},
                         **add_bounds([bd for _, n, *_, bd in k4dx
                                       for _ in range(n)])),
                     **add_bounds([bd for _, n, *_, bd in k10
                                   for _ in range(n)])))

    # K11 at the three levels: forward bitwise with identical selections,
    # backward within TRAIN_GRAD_RTOL
    npts = torch.clamp(batch["num_points"], min=1)[..., None].float()
    query = (batch["voxels"][..., :3].sum(-2) / npts).contiguous()
    cell0 = batch["coords"]
    pc = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32).tolist()
    k11 = {}
    for level, c in ((1, 32), (2, 64), (3, 64)):
        vs = (np.asarray(cfg.voxel.voxel_size, np.float32)
              * 2 ** level).tolist()
        k11[level] = ring_interp_level(
            torch, "", query, cell0, level, randn(2, caps[level], c),
            batch[f"plan_aux{level}"], vs, pc,
            randn(*query.shape[:2], c))
    rows.append(ring_interp_row(
        k11, "K11 ring_interp", "sassd_tpu/ops/interpolate.py:115",
        "batch 2, levels 1-3"))

    # K12: the voxel centroids of the two scans against their GT boxes
    pvalid = batch["coords"][..., 0] >= 0
    gt, gv = (torch.from_numpy(a).to(device) for a in gts)
    label, off, err12 = k12_check(torch, "phase 3's inputs", query, pvalid,
                                  gt, gv)
    print(f"  K12 points in boxes {label.sum(1).tolist()}")
    if not label.any():
        fail("K12: no point of phase 3's scans is in a GT box")
    t12 = measured(lambda: boxes.aux_targets(query, pvalid, gt, gv),
                   "K12 aux_targets, batch 2", iters=100)
    plain_ms = cuda_ms(lambda: boxes.aux_targets_plain(query, pvalid, gt,
                                                       gv))
    rows.append(dict(name="K12 aux_targets", route="cuda",
                     source="sassd_tpu_torch/csrc/points_in_boxes.cu",
                     replaces="sassd_tpu/core/boxes.py:281",
                     max_abs_err=err12, **t12,
                     plain_ms=plain_ms, library_ms=None,
                     library_what="none: torch has no points-in-rotated-"
                                  "boxes test",
                     at="batch 2, 20,000-voxel cap, 64 GT slots",
                     **k12_bound(torch, query, pvalid, gt, gv, label, off)))

    # K3b: [2, 28, 200, 176] part map, 640 guided boxes a sample
    b, k, h, w, n = 2, 28, 200, 176, cfg.caps.guided_train
    part_map = randn(b, k, h, w)
    bx = np.zeros((b, n, 7), np.float32)
    bx[..., 0] = rng.uniform(0, 70.4, (b, n))
    bx[..., 1] = rng.uniform(-40, 40, (b, n))
    bx[..., 2] = -1.7
    bx[..., 3:6] = rng.uniform([1.4, 3.2, 1.4], [1.9, 4.5, 1.8], (b, n, 3))
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    boxes3 = torch.from_numpy(bx).to(device)
    valid = torch.from_numpy(rng.uniform(size=(b, n)) < 0.9).to(device)
    d_score = randn(b, n)
    args = (cfg.model.window_size, cfg.model.grid_offsets,
            1.0 / cfg.model.featmap_stride)

    def k3b():
        return warp.pswarp_score_grad(part_map, boxes3, valid, d_score, *args)
    err3b, (pm, pb, out_p) = k3b_check(torch, "phase 3's inputs", part_map,
                                       boxes3, valid, d_score, args)
    t3b = timed(k3b)
    plain_ms = grad_ms(out_p, (pm, pb), d_score)
    print(f"  K3b: kernel {fmt_timed(t3b)}, plain (autograd) {plain_ms:.4f} "
          f"ms; {fmt_split(k3b)}")
    print(f"  K3b {host_split(k3b)[1]}")
    heights = []                    # pass B's tile height, replayed
    default_rows = warp.K3B_TILE_ROWS
    try:
        for rows_b in K3B_ROWS_TRIED:
            warp.K3B_TILE_ROWS = rows_b
            heights.append(f"{rows_b} rows {graph_ms(k3b):.4f}")
    finally:
        warp.K3B_TILE_ROWS = default_rows
    print(f"  K3b replayed by pass B's tile height (diagnostic; "
          f"{default_rows} in use): {', '.join(heights)} ms")
    zeros_ms = graph_ms(lambda: torch.zeros((b, k, h, w), device=device))
    print(f"  lone replay, not a kernel row: torch.zeros of K3b's d_map "
          f"{(b, k, h, w)}, {zeros_ms:.4f} ms")
    rows.append(dict(name="K3b pswarp_score_grad", route="cuda",
                     source="sassd_tpu_torch/csrc/pswarp_score.cu",
                     replaces="sassd_tpu/ops/warp.py:76",
                     max_abs_err=err3b, err_kind="relative to max |plain|",
                     **t3b, plain_ms=plain_ms, library_ms=None,
                     library_what="none: as K3, grid_sample's backward "
                                  "covers every channel at every point",
                     at="batch 2, 640 boxes a sample",
                     # d_score, boxes, valid, 4 map taps a part in; the
                     # whole d_map (zeros included) and d_boxes out; ~100
                     # operations a part
                     **bound(b * n * (4 + 28 + 1 + 28) + b * n * k * 16
                             + part_map.numel() * 4, b * n * k * 100)))

    # K5b: the level-3 rows of both scans from a [2, 320, 200, 176] canvas
    keys3 = sp.coords_to_keys(batch["plan_coords3"], shapes[3])
    d3, h3, w3 = shapes[3]
    d_canvas = randn(2, d3 * 64, h3, w3)
    got = sp.densify_grad(keys3, d_canvas, shapes[3])
    ref = sp.densify_grad_plain(keys3, d_canvas, shapes[3])
    same5b = torch.equal(got, ref)
    print(f"K5b densify_grad {tuple(d_canvas.shape)} -> {tuple(got.shape)}:"
          f" {'bitwise equal to' if same5b else 'DIFFERS from'} plain")
    if not same5b:
        fail("K5b differs from its plain version")
    ms = cuda_ms(lambda: sp.densify_grad(keys3, d_canvas, shapes[3]),
                 iters=100)
    dev_ms = graph_ms(lambda: sp.densify_grad(keys3, d_canvas, shapes[3]),
                      iters=100)
    plain_ms = cuda_ms(lambda: sp.densify_grad_plain(keys3, d_canvas,
                                                     shapes[3]))
    n_rows = int((keys3 != sp.INVALID_KEY).sum())
    # the one-call yardstick: one gather of the active rows from the
    # [B, D, C, H, W] view of the canvas gradient
    bzyx = keys_bzyx(torch, keys3, shapes[3])
    dv = d_canvas.view(2, d3, 64, h3, w3)

    def gather5b():
        return dv[bzyx[0], bzyx[1], :, bzyx[2], bzyx[3]]
    lib_ms = cuda_ms(gather5b, iters=100)
    lib_graph_ms = graph_ms(gather5b, iters=100)
    # the replays reread the same sectors of the 90 MB canvas, at most
    # 42 MB at one 32-byte sector an active (row, channel), which the 50 MB
    # L2 can
    # keep between calls; the cold-L2 times need no such luck
    cold = cold_ms(lambda: sp.densify_grad(keys3, d_canvas, shapes[3]))
    lib_cold = cold_ms(gather5b)
    # an estimate for a cold L2, printed only: one 32-byte sector per
    # active (row, channel), the row's values lying H*W floats apart
    sector_ms = n_rows * 64 * 32 / HBM_BYTES_PER_S * 1e3
    print(f"  K5b kernel {ms:.4f} ms ({dev_ms:.4f} replayed from a CUDA "
          f"graph, L2 warm; {cold:.4f} with the L2 cold), plain "
          f"{plain_ms:.4f} ms; one-call yardstick (gather of the active "
          f"rows) {lib_ms:.4f} ms ({lib_graph_ms:.4f} replayed; "
          f"{lib_cold:.4f} cold); {n_rows} active rows, sector estimate "
          f"(L2 cold) {sector_ms:.4f} ms")
    rows.append(dict(name="K5b densify_grad", route="cuda",
                     source="sassd_tpu_torch/csrc/densify.cu",
                     replaces="sassd_tpu/ops/sparse.py:835",
                     max_abs_err=float((got - ref).abs().max()), ms=ms,
                     graph_ms=dev_ms, cold_l2_ms=cold, plain_ms=plain_ms,
                     library_ms=lib_ms, library_graph_ms=lib_graph_ms,
                     library_cold_l2_ms=lib_cold,
                     library_what="one advanced-index gather of the active "
                                  "rows (padding rows not zeroed)",
                     at="batch 2, 10,240-row cap",
                     # keys and the active rows' canvas values in, rows out
                     **bound(keys3.numel() * 4 + n_rows * 64 * 4
                             + got.numel() * 4, 0)))
    return rows


def k14_bound(torch, cell0, shapes) -> dict:
    """K14's bound: cell0 read once, the three [B, 27, M0] int32 plans
    written once, and each level's map read once at the distinct in-grid
    cells of the valid rows' 3x3x3 windows (key-sorted neighbours share
    most of them)."""
    b, m0, _ = cell0.shape
    valid = cell0[..., 0] >= 0
    rows = cell0[valid].to(torch.int64)
    sample = torch.arange(b, device=cell0.device)[:, None].expand(b, m0)[
        valid][:, None]
    taps = torch.tensor([(dz, dy, dx) for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        device=cell0.device)
    cells = 0
    for lvl, (d, h, w) in enumerate(shapes, 1):
        q = (rows >> lvl)[:, None, :] + taps                   # [n, 27, 3]
        ok = ((q >= 0) & (q < torch.tensor([d, h, w],
                                           device=cell0.device))).all(-1)
        lin = ((sample * d + q[..., 0]) * h + q[..., 1]) * w + q[..., 2]
        cells += int(torch.unique(lin[ok]).numel())
    return dict(**bound(cell0.numel() * 4 + 3 * b * 27 * m0 * 4 + cells * 4,
                        0), map_cells_read=cells)


def k13_bound(torch, keys, shapes) -> dict:
    """K13's bound: the keys of levels 0-2 read once, the three [B, 27, M]
    int32 plans written once, and each distinct 32-byte sector of the
    level maps that a live tap reads (a sector is the least the card
    reads), at this run's rows."""
    from sassd_tpu_torch.ops import sparse as sp
    dev = keys[0].device
    taps = torch.tensor([(dz, dy, dx) for dz in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        device=dev)
    nbytes = sectors = live_taps = 0
    for lvl, k in enumerate(keys):
        b, m = k.shape
        nbytes += k.numel() * 4 + 27 * k.numel() * 4
        c = sp.keys_to_coords(k, shapes[lvl]).to(torch.int64)
        valid = c[..., 0] >= 0
        q = c[valid][:, None, :] - taps                        # [n, 27, 3]
        od, oh, ow = shapes[lvl + 1]
        live = ((q >= 0) & (q % 2 == 0)
                & (q // 2 < torch.tensor([od, oh, ow], device=dev))).all(-1)
        p = q // 2
        sample = torch.arange(b, device=dev)[:, None].expand(b, m)[valid]
        lin = (sample[:, None] * (od * oh * ow)
               + (p[..., 0] * oh + p[..., 1]) * ow + p[..., 2])
        sectors += int(torch.unique(lin[live] // 8).numel())
        live_taps += int(live.sum())
    return dict(**bound(nbytes + sectors * 32, 0), map_sectors_read=sectors,
                live_taps=live_taps)


def k13_check(torch, what: str, keys, maps, shapes, strides, host=None):
    """K13's one call for the three levels (keys of levels 0-3, index maps
    of levels 1-3, the four grids) held bitwise against its plain version,
    the forward stride plans inverted and, where given, the C++ train
    rulebook's strideT plans; read four ways by measured() beside its
    yardstick (torch.full + index_put_ of the forward plans' found
    entries, the three levels, also by measured()). Returns its row."""
    from sassd_tpu_torch.ops import sparse as sp
    sys.path.insert(0, os.path.join(HERE, "tests"))
    # the parent design, the forward plans inverted: the tests' oracle
    from test_torch_cases import invert_stride_plan

    def k13():
        return sp.stride_plans_T(keys[:3], maps, shapes)
    got = k13()
    ref = sp.stride_plans_T_plain(keys[:3], maps, shapes)
    diff, puts = {}, []
    for lvl, (g, r, fwd) in enumerate(zip(got, ref, strides), 1):
        inv = invert_stride_plan(fwd, keys[lvl - 1].shape[1])
        diff[f"strideT{lvl}"] = (int((g != r).sum()), int((g != inv).sum()),
                                 None if host is None
                                 else int((g != host[lvl - 1]).sum()))
        bk, kk, oo = torch.nonzero(fwd >= 0, as_tuple=True)
        puts.append((tuple(g.shape), (bk, kk, fwd[bk, kk, oo].long()),
                     oo.to(torch.int32)))
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    print(f"K13 stride_plans_T, {what}: entries differing (from plain, from "
          f"the forward plans inverted, from the C++ train rulebook): "
          f"{diff}; max|kernel-plain| {err:g}")
    if any(v for d in diff.values() for v in d):
        fail(f"K13 differs from its plain version, the inverted forward "
             f"plans or the C++ train rulebook ({what})")

    def put13():
        for shape, idx, val in puts:
            out = torch.full(shape, -1, dtype=torch.int32,
                             device=keys[0].device)
            out.index_put_(idx, val)
    t = measured(k13, f"K13 stride_plans_T, {what}", iters=100)
    lib = measured(put13, f"K13's yardstick (torch.full + index_put_, three "
                          f"levels), {what}", iters=100)
    plain_ms = cuda_ms(lambda: sp.stride_plans_T_plain(keys[:3], maps,
                                                       shapes))
    bd = k13_bound(torch, keys[:3], shapes)
    print(f"  K13 bound, {what}: {bd['bound_ms']:.4f} ms (bytes: plans "
          f"written, keys read, {bd['map_sectors_read']} map sectors of 32 "
          f"bytes for {bd['live_taps']} live taps); plain {plain_ms:.4f} ms")
    return dict(name="K13 stride_plans_T", route="cuda",
                source="sassd_tpu_torch/csrc/device_plans.cu",
                replaces="sassd_tpu/ops/sparse.py:732", max_abs_err=err,
                **t, plain_ms=plain_ms, library_ms=lib["ms"],
                library_graph_ms=lib["graph_ms"],
                library_profiler_ms=lib["profiler_ms"],
                library_host_us=lib["host_us"],
                library_what="torch.full(-1) + index_put_ of the forward "
                             "plans' found entries, the three levels",
                at=what, **bd)


def level_centers(np, cfg, coords, level):
    """Cell centres [B, M, 3] xyz of a level's zyx coords (the aux branch's
    known points of the exact 3-NN)."""
    from sassd_tpu_torch.ops import interpolate as itp
    vs = np.asarray(cfg.voxel.voxel_size, np.float32) * 2 ** level
    pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    return itp.cell_centers(coords, vs.tolist(), pcr.tolist())


def check_train_plan_kernels(torch, np, device, cfg, samples):
    """Phase 3, the kernels of training without host plans, at batch 2 on
    the train plans of the first two car scans: K13 (transpose plans, also
    against the forward plans inverted) and K14 (aux ring plans) against
    their plain versions and the C++ train rulebook, bitwise; K15 (exact
    3-NN) against its plain version at the full level sizes: rows, weights
    and features bitwise, and its backward (K11's) within
    TRAIN_GRAD_RTOL."""
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops import sparse as sp

    rng = np.random.default_rng(SEED + 5)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples[:2]])).to(
        device) for k in samples[0] if k != "meta"}
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    shapes = [cfg.sparse_shape]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    cell0 = batch["coords"]
    rows = []

    # K13: the three levels' transpose plans in one call, from the keys of
    # levels 0-2 and the index maps of levels 1-3 (K14 reads the same maps)
    keys = [sp.coords_to_keys(cell0, shapes[0])] + [
        sp.coords_to_keys(batch[f"plan_coords{lvl}"], shapes[lvl])
        for lvl in (1, 2, 3)]
    maps = [sp.build_index_map(k, s) for k, s in zip(keys[1:], shapes[1:])]
    rows.append(k13_check(
        torch, "batch 2, levels 1-3 in one call", keys, maps, shapes,
        [batch[f"plan_stride{lvl}"].to(torch.int32) for lvl in (1, 2, 3)],
        [batch[f"plan_strideT{lvl}"].to(torch.int32) for lvl in (1, 2, 3)]))

    # K14: the three levels' aux plans in one call
    got = sp.aux_plans(cell0, maps, shapes[1:])
    diff, err = {}, {}
    ref = sp.aux_plans_plain(cell0, maps, shapes[1:])
    for lvl in (1, 2, 3):
        host = batch[f"plan_aux{lvl}"].to(torch.int32)
        diff[f"aux{lvl}"] = (int((got[lvl - 1] != ref[lvl - 1]).sum()),
                             int((got[lvl - 1] != host).sum()))
        err[f"aux{lvl}"] = float((got[lvl - 1] - ref[lvl - 1]).abs().max())
    print(f"K14 aux_plans, batch 2, levels 1-3: entries differing (from "
          f"plain, from the C++ train rulebook): {diff}; max|kernel-plain|: "
          f"{err}")
    if any(a or b for a, b in diff.values()):
        fail("K14 differs from its plain version or the C++ train rulebook")
    # the three-level call at batch 2 and at phase 8's batch-1 shape (one
    # scan: multi_config shares the car grid and caps)
    t14 = measured(lambda: sp.aux_plans(cell0, maps, shapes[1:]),
                   "K14 aux_plans, batch 2, levels 1-3 in one call",
                   iters=100)
    plain_ms = cuda_ms(lambda: sp.aux_plans_plain(cell0, maps, shapes[1:]))
    cell0_b1, maps_b1 = cell0[:1], [m[:1] for m in maps]
    t14_b1 = measured(lambda: sp.aux_plans(cell0_b1, maps_b1, shapes[1:]),
                      "K14 aux_plans, batch 1 (phase 8's shape)", iters=100)
    for what, c in (("batch 2", cell0), ("batch 1", cell0_b1)):
        fill = kernel_split(lambda: torch.full(
            (3, c.shape[0], 27, c.shape[1]), -1, dtype=torch.int32,
            device=device))
        print(f"  K14's plans written alone, {what} (diagnostic, not in the "
              f"row: torch.full(-1) of the [3, B, 27, M0] buffer, profiler "
              f"ms a call): {sum(fill.values()):.4f}")
    bd14, bd14_b1 = (k14_bound(torch, c, shapes[1:])
                     for c in (cell0, cell0_b1))
    print(f"  K14 aux_plans bound: batch 2 {bd14['bound_ms']:.4f} ms, "
          f"batch 1 {bd14_b1['bound_ms']:.4f} ms; plain (batch 2) "
          f"{plain_ms:.4f} ms")
    rows.append(dict(name="K14 aux_plans", route="cuda",
                     source="sassd_tpu_torch/csrc/device_plans.cu",
                     replaces="sassd_tpu/ops/sparse.py:785",
                     max_abs_err=max(err.values()),
                     **t14, plain_ms=plain_ms, library_ms=None,
                     library_what="none: the window's tap cells and edge "
                                  "masks take several calls before one "
                                  "gather",
                     at="batch 2, levels 1-3 in one call",
                     batch1=dict(t14_b1, bound_ms=bd14_b1["bound_ms"]),
                     **bd14))
    del maps, keys

    # K15 at the three levels: the voxel centroids of both scans against
    # every cell centre of the level
    npts = torch.clamp(batch["num_points"], min=1)[..., None].float()
    query = (batch["voxels"][..., :3].sum(-2) / npts).contiguous()
    k15, err15 = [], 0.0
    for lvl, c in ((1, 32), (2, 64), (3, 64)):
        coords = batch[f"plan_coords{lvl}"]
        centers = level_centers(np, cfg, coords, lvl).contiguous()
        valid = (coords[..., 0] >= 0).contiguous()
        feats = torch.from_numpy(rng.normal(
            size=(2, caps[lvl], c)).astype(np.float32)).to(device)
        out, rsel, wsel = itp.three_nn_fwd(query, centers, valid, feats)
        ref_rows, ref_w = itp.three_nn_select_plain(query, centers, valid)
        ref = itp.three_nn_interpolate_plain(query, centers, valid, feats)
        same = (torch.equal(rsel.long(), ref_rows)
                and torch.equal(wsel, ref_w) and torch.equal(out, ref))
        fwd_err = rel_err(out, ref)
        cot = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
            np.float32)).to(device)
        fk = feats.clone().requires_grad_()
        itp.three_nn_interpolate(query, centers, valid, fk).backward(cot)
        fp = feats.clone().requires_grad_()
        out_p = itp.three_nn_interpolate_plain(query, centers, valid, fp)
        bwd_err = rel_err(fk.grad, torch.autograd.grad(
            out_p, fp, cot, retain_graph=True)[0])
        err15 = max(err15, fwd_err, bwd_err)
        print(f"K15 three_nn level {lvl} {tuple(query.shape)} x "
              f"{tuple(centers.shape)} -> {tuple(out.shape)}: rows, "
              f"weights and output "
              f"{'bitwise equal to' if same else 'DIFFER from'} plain; "
              f"backward (K11) rel err {bwd_err:.3g} (tol {TRAIN_GRAD_RTOL})")
        if not same or bwd_err > TRAIN_GRAD_RTOL:
            fail(f"K15 disagrees with its plain version at level {lvl}")
        ms = cuda_ms(lambda: itp.three_nn_fwd(query, centers, valid, feats))
        dev_ms = graph_ms(lambda: itp.three_nn_fwd(query, centers, valid,
                                                   feats))
        bwd_ms = cuda_ms(lambda: itp.ring_interp_bwd(cot, rsel, wsel,
                                                     feats.shape))
        plain_ms = cuda_ms(lambda: itp.three_nn_interpolate_plain(
            query, centers, valid, feats), iters=3)
        plain_bwd_ms = grad_ms(out_p, fp, cot)
        q = query.shape[0] * query.shape[1]
        m = centers.shape[1]
        # queries, known points, validity, 3 feature rows a query (at most
        # the level) in; features, rows and weights out; 9 float32
        # operations a (query, known) pair: the dot (5), u2 + k2, 2 * dot,
        # the difference and the validity bias
        bd = bound(q * 12 + 2 * m * 13 + min(feats.numel(), 3 * q * c) * 4
                   + q * c * 4 + q * 24, q * m * 9)
        # an estimate, printed only: those operations issued one by one
        # (-fmad=false), with a compare and the bit it sets, 10
        # instructions a pair at one a lane and cycle
        instr_ms = q * m * 10 / INSTR_PER_S * 1e3
        print(f"  K15 level {lvl}: kernel {ms:.4f} ms ({dev_ms:.4f} "
              f"replayed from a CUDA graph), plain {plain_ms:.4f} ms; "
              f"bound {bd['bound_ms']:.4f} ms (operations), unfused "
              f"instruction estimate {instr_ms:.4f} ms")
        k15.append((lvl, ms, dev_ms, bwd_ms, plain_ms, plain_bwd_ms, bd))
    rows.append(dict(name="K15 three_nn", route="cuda",
                     source="sassd_tpu_torch/csrc/interpolate.cu",
                     replaces="sassd_tpu/ops/interpolate.py:23",
                     max_abs_err=err15, err_kind="relative to max |plain|; "
                     "rows, weights and output bitwise",
                     ms=sum(m for _, m, *_ in k15),
                     graph_ms=sum(g for _, _, g, *_ in k15),
                     plain_ms=sum(pm for *_, pm, _, _ in k15),
                     library_ms=None,
                     library_what="none: the masked distances, the top 3 "
                                  "and the weighted gather are separate "
                                  "calls (cdist has no validity mask)",
                     backward_ms=sum(bm for _, _, _, bm, *_ in k15),
                     plain_backward_ms=sum(pbm for *_, pbm, _ in k15),
                     at="batch 2, forward, levels 1-3 (backward: K11's "
                        "sassd_ring_interp_bwd)",
                     per_level={lv: dict(ms=m, graph_ms=g, backward_ms=bm,
                                         plain_ms=pm,
                                         plain_backward_ms=pbm, **bd)
                                for lv, m, g, bm, pm, pbm, bd in k15},
                     **add_bounds([bd for *_, bd in k15])))
    return rows


def check_once(sp, launches: dict, what: str, kid: str, want: int):
    """Print a kernel's launches in one train step and fail unless they
    are `want`: K13 makes the three levels' transpose plans in one launch
    on every device-plans train step, K14 the aux plans (ring aux only)."""
    n = sum(launches[s] for s in sp.KERNEL_SYMBOLS[kid])
    print(f"{what}: {kid} (three levels a launch) launched {n} time(s) in "
          f"one train step (want {want})")
    if n != want:
        fail(f"{what}: {kid} launched {n} times in one step, not {want}")


def det_pairs(a, b, what: str) -> list:
    """Index pairs of two detection sets (dicts of numpy boxes and scores)
    matched within DET_BOX_ATOL / DET_SCORE_ATOL, every detection once;
    fails otherwise."""
    import numpy as np
    if len(a["boxes"]) != len(b["boxes"]):
        fail(f"{what}: {len(a['boxes'])} vs {len(b['boxes'])} detections")
    used = np.zeros(len(b["boxes"]), bool)
    pairs = []
    for i, (bx, sc) in enumerate(zip(a["boxes"], a["scores"])):
        ok = ((np.abs(b["boxes"] - bx).max(1) <= DET_BOX_ATOL)
              & (np.abs(b["scores"] - sc) <= DET_SCORE_ATOL) & ~used)
        if not ok.any():
            fail(f"{what}: detection {i} {bx} score {sc:.5f} has no match")
        used[np.argmax(ok)] = True
        pairs.append((i, int(np.argmax(ok))))
    return pairs


def match_detections(a, b, what: str):
    """Match two detection sets (dicts of numpy, one sample) within the
    tolerances; returns the number of detections."""
    va, vb = a["valid"], b["valid"]
    return len(det_pairs({k: a[k][va] for k in ("boxes", "scores")},
                         {k: b[k][vb] for k in ("boxes", "scores")}, what))


def run_phase(torch, np, device, cfg, model_dev, anchors, samples,
              what: str):
    """Phases 4 and 5: forward_test on the card over every sample at batch
    1 and over the first two at batch 2, with the launch counts reset just
    before and read just after. Returns (dets1, dets2, ms1, ms2,
    launches)."""
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step

    step = make_test_step(cfg, anchors, device)
    batch1 = [kitti.collate([s])[0] for s in samples]
    batch2 = kitti.collate(samples[:2])[0]
    for b in batch1[:1] + [batch2]:                 # warm-up (cuDNN, build)
        step(model_dev, b)
    torch.cuda.synchronize()

    reset_launches()
    dets1, ms1 = [], []
    for b in batch1:
        t = time.perf_counter()
        d = step(model_dev, b)
        torch.cuda.synchronize()
        ms1.append((time.perf_counter() - t) * 1e3)
        dets1.append({k: v.cpu().numpy() for k, v in d.items()})
    t = time.perf_counter()
    d2 = step(model_dev, batch2)
    torch.cuda.synchronize()
    ms2 = (time.perf_counter() - t) * 1e3
    launches = read_launches()
    dets2 = {k: v.cpu().numpy() for k, v in d2.items()}

    print(f"{what}: launches {launches}")
    for i, d in enumerate(dets1 + [dets2]):
        if not (np.isfinite(d["boxes"]).all()
                and np.isfinite(d["scores"]).all()):
            fail(f"{what}: non-finite detections in run {i}")
    counts = [match_detections(dets1[i], {k: v[i] for k, v in dets2.items()},
                               f"{what}, scan {i}: batch 2 vs batch 1")
              for i in range(2)]
    print(f"{what}: batch 2 agrees with batch 1 ({counts} detections); "
          f"guided candidates truncated by the cap: "
          f"{[int(d['guided_truncated'][0]) for d in dets1]}")
    return dets1, dets2, ms1, ms2, launches


def check_cpu(np, cfg, model, anchors, sample, dets, what: str):
    """One scan through the plain versions on the CPU == the card."""
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step
    t = time.perf_counter()
    cpu = make_test_step(cfg, anchors, "cpu")(model, kitti.collate([sample])[0])
    cpu_s = time.perf_counter() - t
    cpu = {k: v.numpy() for k, v in cpu.items()}
    n = match_detections(dets, cpu, f"{what}, scan 0: card vs CPU")
    print(f"{what}: card vs CPU (plain versions, {cpu_s:.1f} s): {n} "
          f"detections match (boxes {DET_BOX_ATOL}, scores "
          f"{DET_SCORE_ATOL})")


def unique_voxels(np, points, cfg) -> int:
    """In-range unique voxel count of a raw scan (no cap)."""
    pcr = np.asarray(cfg.voxel.point_cloud_range[:3], np.float32)
    vs = np.asarray(cfg.voxel.voxel_size, np.float32)
    c = np.floor((points[:, :3] - pcr) / vs).astype(np.int64)
    c = c[np.all((c >= 0) & (c < cfg.voxel.grid_size), axis=1)]
    return len(np.unique(c, axis=0))


def match_annos(np, a, b, what: str) -> int:
    """Two KITTI annotations of one scan equal as sets: camera-frame
    location and dimensions within the box tolerance, score within the
    score tolerance."""
    if len(a["name"]) != len(b["name"]):
        fail(f"{what}: {len(a['name'])} vs {len(b['name'])} detections")
    used = np.zeros(len(b["name"]), bool)
    for i in range(len(a["name"])):
        ok = ((np.abs(b["location"] - a["location"][i]).max(1)
               <= DET_BOX_ATOL)
              & (np.abs(b["dimensions"] - a["dimensions"][i]).max(1)
                 <= DET_BOX_ATOL)
              & (np.abs(b["score"] - a["score"][i]) <= DET_SCORE_ATOL)
              & ~used)
        if not ok.any():
            fail(f"{what}: detection {i} at {a['location'][i]} score "
                 f"{a['score'][i]:.5f} has no match")
        used[np.argmax(ok)] = True
    return len(a["name"])


def run_serving(torch, np, device, cfg, model_dev, model_cpu, root: str):
    """Phase 6: device-resident serving through run_inference and the KITTI
    evaluator. Returns (launches, ms1, ms2, host_ms, launches of one
    batch-1 step)."""
    from sassd_tpu_torch import inference, serve
    from sassd_tpu_torch.eval import results

    cfg_pts, ds, step, batch1, batch2 = serving_split(torch, np, device, cfg,
                                                      root)
    data_root = os.path.join(root, "training")
    for b in (batch1[0], batch2[0]):                 # warm-up
        step(model_dev, b)
    torch.cuda.synchronize()

    reset_launches()
    runs = {bs: inference.run_inference(cfg_pts, ds, model_dev, bs, device)
            for bs in (1, 2)}
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"serving: launches {launches}")

    host = inference.run_inference(cfg, ds, model_dev, 1, device)
    n_unique = [unique_voxels(np, ds.load_points(i)[0], cfg)
                for i in range(N_SCANS)]
    print(f"serving: in-range voxels per scan {n_unique} (cap "
          f"{cfg.voxel.max_voxels})")
    counts = []
    for i in range(N_SCANS):
        if n_unique[i] >= cfg.voxel.max_voxels:
            print(f"serving, scan {i}: over the voxel cap, the host and "
                  f"device voxelizers keep different voxels; not compared")
            continue
        counts.append(match_annos(np, runs[1][0][i], host[0][i],
                                  f"serving, scan {i}: points vs voxels"))
        match_annos(np, runs[2][0][i], runs[1][0][i],
                    f"serving, scan {i}: batch 2 vs batch 1")
    if not counts:
        fail("serving: no scan under the voxel cap to compare")
    print(f"serving: points mode agrees with voxels mode and batch 2 with "
          f"batch 1 on {len(counts)} scans ({counts} detections in the "
          f"image)")

    t = time.perf_counter()
    cpu = serve.make_serving_step(cfg_pts, ds.anchors, ds.anchors_bv,
                                  "cpu")(model_cpu, batch1[0])
    cpu_s = time.perf_counter() - t
    card = step(model_dev, batch1[0])
    n = match_detections({k: v.cpu().numpy() for k, v in card.items()},
                         {k: v.numpy() for k, v in cpu.items()},
                         "serving, scan 0: card vs CPU")
    print(f"serving: card vs CPU (plain versions, {cpu_s:.1f} s): {n} "
          f"detections match")

    annos, ids = runs[1]
    results.write_result_files(annos, ids, os.path.join(root, "results"))
    _, text = inference.evaluate(cfg_pts, ds, None,
                                 os.path.join(data_root, "label_2"),
                                 precomputed=runs[1])
    if "Car AP@" not in text:
        fail("serving: evaluate printed no AP table")
    print(f"serving: wrote {len(ids)} result files; KITTI AP (random "
          f"weights):\n{text}")

    torch.cuda.synchronize()
    reset_launches()
    step(model_dev, batch1[0])
    torch.cuda.synchronize()
    per_step = read_launches()
    ms1, ms2 = [], []
    for b in batch1:
        t = time.perf_counter()
        step(model_dev, b)
        torch.cuda.synchronize()
        ms1.append((time.perf_counter() - t) * 1e3)
    for b in batch2:
        t = time.perf_counter()
        step(model_dev, b)
        torch.cuda.synchronize()
        ms2.append((time.perf_counter() - t) * 1e3 / 2)
    raw = [ds.load_points(i)[0] for i in range(N_SCANS)]
    t = time.perf_counter()
    for p in raw:
        serve.prepare_points(p, cfg_pts)
    host_ms = (time.perf_counter() - t) * 1e3 / N_SCANS
    return launches, ms1, ms2, host_ms, per_step


def step_gates(torch, res: dict, what: str) -> None:
    """Phase 7's gates on one train step run three ways, res[name] =
    (losses, seconds, gradients by parameter name) for "card", "cpu" and
    "cpu64": every loss card vs CPU within TRAIN_LOSS_RTOL, equal guided
    counts, and the card's gradients against the float64 step's (the
    global norm within TRAIN_GNORM_RTOL, each module within
    TRAIN_GRAD_L2 relative L2)."""
    (l64, s64, g64), (cl, cs, cgr), (gl, _, ggr) = (
        res[k][:3] for k in ("cpu64", "cpu", "card"))
    for k, v in cl.items():
        print(f"{what}, card vs CPU: {k} {gl[k]:.7g} vs {v:.7g} "
              f"(float64 {l64[k]:.7g})")

    def gnorm(g, keys):
        return sum(float(torch.sum(g[k] ** 2)) for k in keys) ** 0.5

    def gerr(g, keys):
        return (sum(float(torch.sum((g[k] - g64[k]) ** 2)) for k in keys)
                ** 0.5 / max(gnorm(g64, keys), 1e-300))
    keys = list(g64)
    norm_err = abs(gnorm(ggr, keys) - gnorm(g64, keys)) / gnorm(g64, keys)
    print(f"{what}: grad norm card {gnorm(ggr, keys):.7g}, CPU "
          f"{gnorm(cgr, keys):.7g}, float64 CPU {gnorm(g64, keys):.7g} "
          f"(CPU steps {cs:.1f} s, {s64:.1f} s in float64)")
    mod_err = {}
    for mod in ("vxnet", "bevnet", "head", "pswarp", "aux"):
        mk = [k for k in keys if k.startswith(mod + ".")]
        mod_err[mod] = gerr(ggr, mk)
        print(f"{what}: {mod} gradients, rel L2 error against float64: "
              f"card {mod_err[mod]:.3g}, CPU {gerr(cgr, mk):.3g}")
    for k in ("guided_valid", "guided_pos"):
        if gl[k] != cl[k]:
            fail(f"{what}: {k} {gl[k]} on the card vs {cl[k]} on the CPU")
    bad = [k for k, v in cl.items() if "loss" in k
           and not abs(gl[k] - v) <= TRAIN_LOSS_RTOL * abs(v)]
    if (bad or norm_err > TRAIN_GNORM_RTOL
            or max(mod_err.values()) > TRAIN_GRAD_L2):
        fail(f"{what}: card and CPU disagree on {bad or 'the gradients'}")


def run_training(torch, np, device, cfg, root: str):
    """Phase 7: car-config training on a synthetic KITTI train split.
    Returns (launches of the run, launches of one step, ms/step list,
    host leg ms/step, losses of the card step, and for phase 13 the batch,
    the anchors and the float64 CPU and float32 card steps' gradients)."""
    import dataclasses
    import logging
    from sassd_tpu_torch import weights
    from sassd_tpu_torch.core import boxes as box_ops
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.inference import to_device
    from sassd_tpu_torch.models.detector import Detector, parse_losses
    from sassd_tpu_torch.ops import warp
    from sassd_tpu_torch.train import checkpoint as ckpt, loop

    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, log_interval=1,
                                       checkpoint_interval=2),
        data=dataclasses.replace(cfg.data, num_workers=2))
    synthetic.write_synthetic_kitti(root, n_train=N_SCANS, n_val=0,
                                    seed=SEED + 3)
    data_root = os.path.join(root, "training")
    ds = kitti.KittiDataset(cfg, data_root,
                            os.path.join(root, "ImageSets", "train.txt"),
                            train=True)
    t = time.perf_counter()
    samples = [ds[i] for i in range(2)]
    host_ms = (time.perf_counter() - t) * 1e3
    batch = kitti.collate(samples)[0]
    print(f"training: batch 2 of scans {[m['sample_idx'] for m in kitti.collate(samples)[1]]}"
          f", GT boxes {batch['gt_valid'].sum(1).tolist()}, active voxels "
          f"{(batch['coords'][..., 0] >= 0).sum(1).tolist()}")
    anchors = torch.from_numpy(ds.anchors)

    # one step on the card against the same step on the CPU, in float32
    # and in float64 (the gradients' reference: backpropagating through
    # train-mode BatchNorm over 70k-cell maps amplifies float32 rounding)
    res = {}
    k3_in = []                  # the card step's K3 inputs and d_score
    k12_in = []                 # the card step's K12 inputs
    orig_k3, orig_k12 = warp.pswarp_score, box_ops.aux_targets

    def capture_k3(part_map, boxes, valid, *args):
        out = orig_k3(part_map, boxes, valid, *args)
        k3_in.append([part_map.detach().clone(), boxes.detach().clone(),
                      valid.clone(), args])
        out.register_hook(lambda g: k3_in[0].append(g.detach().clone()))
        return out

    def capture_k12(*args):
        k12_in.append([a.detach().clone() for a in args])
        return orig_k12(*args)
    for name, where, dtype in (("cpu64", "cpu", torch.float64),
                               ("cpu", "cpu", torch.float32),
                               ("card", device, torch.float32)):
        model = weights.seeded_detector(cfg, SEED, where).to(dtype)
        model.train()
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in to_device(batch, where).items()}
        t = time.perf_counter()
        if name == "card":
            warp.pswarp_score, box_ops.aux_targets = capture_k3, capture_k12
        try:
            losses = model.forward_train(b, anchors.to(where, dtype))
        finally:
            warp.pswarp_score, box_ops.aux_targets = orig_k3, orig_k12
        parse_losses(losses).backward()
        if where != "cpu":
            torch.cuda.synchronize()
        res[name] = ({k: float(v.detach()) for k, v in losses.items()},
                     time.perf_counter() - t,
                     {k: p.grad.detach().cpu().double()
                      for k, p in model.named_parameters()})
    step_gates(torch, res, "training")
    g64, ggr = res["cpu64"][2], res["card"][2]
    gl = res["card"][0]
    part_map, boxes3, valid, args, d_score = k3_in[0]
    k3b_check(torch, "phase 7's first train step", part_map, boxes3, valid,
              d_score.contiguous(), args)
    k12_check(torch, "phase 7's first train step", *k12_in[0])

    # the short run through train_model
    logged = []

    class Keep(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())
    logger = logging.getLogger("sassd.chip_smoke")
    logger.setLevel(logging.INFO)
    logger.addHandler(Keep())
    work = os.path.join(root, "work")
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    model, opt, steps = loop.train_model(cfg, ds, work,
                                         total_epochs=N_TRAIN_EPOCHS,
                                         device=device, logger=logger)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = read_launches()
    print(f"training: train_model ran {steps} steps in {run_s:.1f} s; "
          f"launches {launches}")
    steps_logged = [m for m in logged if " step " in m]
    for m in steps_logged:
        print("  " + m)
    values = [float(kv.split("=")[1]) for m in steps_logged
              for kv in m.split() if "=" in kv]
    if steps != 2 * N_TRAIN_EPOCHS or opt.count != steps:
        fail(f"training: {steps} steps, {opt.count} updates applied")
    if len(steps_logged) != steps or not np.isfinite(values).all():
        fail("training: a logged loss or metric is not finite")
    if any("nonfinite_skips=0.0000" not in m for m in steps_logged):
        fail("training: an update was skipped as non-finite")
    path = ckpt.latest_checkpoint(work)
    restored = Detector(cfg).to(device)
    ckpt.restore(path, restored)
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 restored.state_dict().values()))
    print(f"training: checkpoints {[os.path.basename(p) for p in ckpt.list_checkpoints(work)]}; "
          f"{os.path.basename(path)} restores {'equal' if same else 'DIFFERENT'} "
          f"parameters and buffers")
    if not same:
        fail("training: the checkpoint does not restore the trained model")

    # timing: synchronised steps on one prepared batch, loader excluded
    step = loop.make_train_step(cfg, ds.anchors, opt, device)
    ms = train_step_ms(torch, step, model, batch)
    reset_launches()
    step(model, batch)
    torch.cuda.synchronize()
    per_step = read_launches()
    ref = dict(batch=batch, anchors=anchors, g64=g64, card32=ggr)
    return launches, per_step, ms, host_ms, gl, ref


def three_nn_diagnostic(torch, np, cfg, query, qvalid, coords, level):
    """The share of valid queries whose K15 3-NN set differs from a
    float64 direct-difference 3-NN over the level's cells, and the largest
    weight difference on the queries whose sets agree (no gate)."""
    from sassd_tpu_torch.ops import interpolate as itp
    centers = level_centers(np, cfg, coords, level).contiguous()
    valid = (coords[..., 0] >= 0).contiguous()
    feats = torch.zeros(coords.shape[:2] + (32,), device=coords.device)
    _, rows, w = itp.three_nn_fwd(query, centers, valid, feats)
    m = centers.shape[1]
    rows = rows.long().view(query.shape[0], -1, 3) % m
    w = w.view(query.shape[0], -1, 3).double()
    differ, n_q, w_err = 0, 0, 0.0
    k64 = centers.double()
    for b in range(query.shape[0]):
        for s in range(0, query.shape[1], 1024):
            ok = qvalid[b, s:s + 1024]
            u = query[b, s:s + 1024].double()
            d2 = ((u[:, None] - k64[b][None]) ** 2).sum(-1)
            d2 = torch.where(valid[b][None], d2, torch.inf)
            best, idx = torch.topk(d2, 3, dim=1, largest=False)
            w64 = 1.0 / (best + 1e-8)
            w64 = w64 / w64.sum(1, keepdim=True)
            got_i, order = torch.sort(rows[b, s:s + 1024], dim=1)
            ref_i, order64 = torch.sort(idx, dim=1)
            same = (got_i == ref_i).all(1) & ok
            differ += int(((got_i != ref_i).any(1) & ok).sum())
            n_q += int(ok.sum())
            dw = (torch.gather(w[b, s:s + 1024], 1, order)
                  - torch.gather(w64, 1, order64)).abs().max(1).values
            if same.any():
                w_err = max(w_err, float(dw[same].max()))
    return differ / max(n_q, 1), w_err, n_q


def run_multi_training(torch, np, device, root: str, host_step_ms):
    """Phase 8: three-class training on device plans (multi_config,
    host_plans=False) on a synthetic three-class split with its GT
    database. Returns the launches of the ring and exact train_model runs
    and of one batch-1 step of each."""
    import dataclasses
    import logging
    from sassd_tpu_torch import weights
    from sassd_tpu_torch.config import multi_config
    from sassd_tpu_torch.data import create_data, kitti, synthetic
    from sassd_tpu_torch.inference import to_device
    from sassd_tpu_torch.models.detector import parse_losses
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.train import loop, optim

    classes = ("Car", "Pedestrian", "Cyclist")
    synthetic.write_synthetic_kitti(root, n_train=N_SCANS, n_val=0,
                                    seed=SEED + 7, classes=classes)
    t = time.perf_counter()
    create_data.create_kitti_info_file(root, splits=("train",))
    db = create_data.create_groundtruth_database(root, "train",
                                                 list(classes))
    db_s = time.perf_counter() - t
    base = multi_config()

    def config(aux: str, host_plans: bool = False):
        return dataclasses.replace(
            base, model=dataclasses.replace(base.model, host_plans=host_plans,
                                            aux_interp=aux),
            train=dataclasses.replace(base.train, batch_size=1,
                                      log_interval=1,
                                      checkpoint_interval=N_MULTI_EPOCHS),
            data=dataclasses.replace(
                base.data, num_workers=2,
                db_info_path=os.path.join(root, "kitti_dbinfos_train.pkl")))
    cfg = config("ring")
    split = os.path.join(root, "ImageSets", "train.txt")
    data_root = os.path.join(root, "training")
    ds = kitti.KittiDataset(cfg, data_root, split, train=True)
    if ds.augmentor is None:
        fail("three-class training: the dataset built no augmentor")
    t = time.perf_counter()
    samples = [ds[i] for i in range(2)]
    leg_ms = (time.perf_counter() - t) * 1e3 / 2
    if any(k.startswith("plan_") for k in samples[0]):
        fail("three-class training: host plans built with host_plans=False")
    n_gt = [int(s["gt_valid"].sum()) for s in samples]
    labels = sorted({int(c) for s in samples
                     for c in s["gt_classes"][s["gt_valid"]]})
    print(f"three-class training: GT database of {len(ds)} scans "
          f"{ {k: len(v) for k, v in db.items()} } in {db_s:.1f} s; "
          f"augmented samples: GT boxes {n_gt}, classes {labels}, active "
          f"voxels {[int((s['coords'][:, 0] >= 0).sum()) for s in samples]}"
          f"; host leg (read + augment + voxelize + mask) {leg_ms:.1f} "
          f"ms/scan")

    # the device rulebook of sample 0 against the C++ train rulebook
    cfg_host = config("ring", host_plans=True)
    t = time.perf_counter()
    host_plans = kitti.build_host_plans(cfg_host, samples[0]["coords"],
                                        train=True)
    host_ms = (time.perf_counter() - t) * 1e3
    model = weights.seeded_detector(cfg, SEED, device)
    shapes = model.vxnet.level_shapes
    keys0 = sp.coords_to_keys(torch.from_numpy(
        samples[0]["coords"][None]).to(device), shapes[0])
    rb = sp.device_rulebook(keys0, shapes, cfg.caps.level_caps[1:],
                            train=True)
    torch.cuda.synchronize()
    diff = {k: int((v[0].cpu().numpy()
                    != host_plans[f"plan_{k}"].astype(np.int32)).sum())
            for k, v in rb.items()}
    if set(rb) != {k[5:] for k in host_plans} - {"subm3"} or any(
            diff.values()):
        fail(f"three-class training: device rulebook differs from the C++ "
             f"train rulebook: {diff}")
    dev_ms = cuda_ms(lambda: sp.device_rulebook(
        keys0, shapes, cfg.caps.level_caps[1:], train=True), iters=10)
    dev_exact_ms = cuda_ms(lambda: sp.device_rulebook(
        keys0, shapes, cfg.caps.level_caps[1:], train=True, aux=False),
        iters=10)
    print(f"three-class training: the device train rulebook ({len(rb)} "
          f"arrays) equals the C++ one bitwise; build time at batch 1: "
          f"card {dev_ms:.3f} ms (ring), {dev_exact_ms:.3f} ms (exact, no "
          f"aux plans), C++ host {host_ms:.1f} ms")

    # the exact 3-NN against float64 direct differences on level 1
    q = torch.from_numpy(samples[0]["voxels"][None]).to(device)
    n = torch.clamp(torch.from_numpy(samples[0]["num_points"][None]).to(
        device), min=1)[..., None].float()
    query = (q[..., :3].sum(-2) / n).contiguous()
    share, w_err, n_q = three_nn_diagnostic(
        torch, np, cfg, query, keys0 != sp.INVALID_KEY, rb["coords1"], 1)
    print(f"three-class training, diagnostic (no gate): K15's 3-NN set "
          f"differs from a float64 direct-difference 3-NN on "
          f"{100 * share:.4f}% of {n_q} queries (level 1, "
          f"{int((rb['coords1'][0, :, 0] >= 0).sum())} cells); largest "
          f"weight difference where the sets agree {w_err:.3g}")

    # one step on device plans against the same step on host plans
    anchors = torch.from_numpy(ds.anchors).to(device)
    res = {}
    for name, c, extra in (("device", cfg, {}), ("host", cfg_host,
                                                 host_plans)):
        m = weights.seeded_detector(c, SEED, device)
        m.train()
        b = to_device(kitti.collate([dict(samples[0], **extra)])[0], device)
        losses = m.forward_train(b, anchors)
        parse_losses(losses).backward()
        torch.cuda.synchronize()
        res[name] = ({k: float(v.detach()) for k, v in losses.items()},
                     {k: p.grad.detach().double()
                      for k, p in m.named_parameters()})
    (dl, dg), (hl, hg) = res["device"], res["host"]
    loss_err = max(abs(dl[k] - v) / max(abs(v), 1e-12)
                   for k, v in hl.items() if "loss" in k)
    keys = list(hg)
    norm_h = sum(float((hg[k] ** 2).sum()) for k in keys) ** 0.5
    norm_d = sum(float((dg[k] ** 2).sum()) for k in keys) ** 0.5
    mod_err = {}
    for mod in ("vxnet", "bevnet", "head", "pswarp", "aux"):
        mk = [k for k in keys if k.startswith(mod + ".")]
        ref = sum(float((hg[k] ** 2).sum()) for k in mk) ** 0.5
        mod_err[mod] = sum(float(((dg[k] - hg[k]) ** 2).sum())
                           for k in mk) ** 0.5 / max(ref, 1e-300)
    print(f"three-class training, device vs host plans on the card: "
          f"largest loss rel diff {loss_err:.3g} (tol {PLANS_LOSS_RTOL}); "
          f"grad norm {norm_d:.7g} vs {norm_h:.7g} (rel diff "
          f"{abs(norm_d - norm_h) / norm_h:.3g}, tol {PLANS_GNORM_RTOL}); "
          f"module rel L2 "
          f"{ {k: float(f'{v:.3g}') for k, v in mod_err.items()} } (tol "
          f"{PLANS_GRAD_L2}); losses {dict(sorted(dl.items()))}")
    for k in ("guided_valid", "guided_pos"):
        if dl[k] != hl[k]:
            fail(f"three-class training: {k} {dl[k]} on device plans vs "
                 f"{hl[k]} on host plans")
    if (loss_err > PLANS_LOSS_RTOL
            or abs(norm_d - norm_h) > PLANS_GNORM_RTOL * norm_h
            or max(mod_err.values()) > PLANS_GRAD_L2):
        fail("three-class training: device and host plans disagree")

    # train_model, ring then exact, and the step times
    logger = logging.getLogger("sassd.chip_smoke.multi")
    logger.setLevel(logging.INFO)
    runs, per_step, times = {}, {}, {}
    batch1 = kitti.collate(samples[:1])[0]
    batch2 = kitti.collate(samples)[0]
    for aux in ("ring", "exact"):
        c = config(aux)
        d = kitti.KittiDataset(c, data_root, split, train=True)
        logged = []

        class Keep(logging.Handler):
            def emit(self, record):
                logged.append(record.getMessage())
        handler = Keep()
        logger.addHandler(handler)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        model, opt, steps = loop.train_model(
            c, d, os.path.join(root, f"work_{aux}"),
            total_epochs=N_MULTI_EPOCHS, device=device, logger=logger)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        runs[aux] = read_launches()
        logger.removeHandler(handler)
        steps_logged = [m for m in logged if " step " in m]
        values = [float(kv.split("=")[1]) for m in steps_logged
                  for kv in m.split() if "=" in kv]
        print(f"three-class training, {aux} aux: train_model ran {steps} "
              f"steps in {run_s:.1f} s; launches {runs[aux]}")
        for m in steps_logged:
            print("  " + m)
        if steps != N_MULTI_EPOCHS * N_SCANS or opt.count != steps:
            fail(f"three-class training, {aux}: {steps} steps, "
                 f"{opt.count} updates applied")
        if len(steps_logged) != steps or not np.isfinite(values).all():
            fail(f"three-class training, {aux}: a logged loss or metric "
                 f"is not finite")
        if any("nonfinite_skips=0.0000" not in m for m in steps_logged):
            fail(f"three-class training, {aux}: an update was skipped")
        step = loop.make_train_step(c, ds.anchors, optim.make_optimizer(
            model, c.train, 1000), device)
        times[aux] = (train_step_ms(torch, step, model, batch1),
                      train_step_ms(torch, step, model, batch2))
        reset_launches()
        step(model, batch1)
        torch.cuda.synchronize()
        per_step[aux] = read_launches()
        check_once(sp, per_step[aux], f"three-class training, {aux} aux",
                   "K13", 1)
        check_once(sp, per_step[aux], f"three-class training, {aux} aux",
                   "K14", 1 if aux == "ring" else 0)
    host_model = weights.seeded_detector(cfg_host, SEED, device)
    host_step = loop.make_train_step(cfg_host, ds.anchors,
                                     optim.make_optimizer(
                                         host_model, cfg_host.train, 1000),
                                     device)
    host_b1 = train_step_ms(torch, host_step, host_model, kitti.collate(
        [dict(samples[0], **host_plans)])[0])
    for aux in ("ring", "exact"):
        b1, b2 = times[aux]
        print(f"three-class training step on device plans, {aux} aux: "
              f"batch 1 {', '.join(f'{m:.2f}' for m in b1)} ms/step; batch "
              f"2 {', '.join(f'{m:.2f}' for m in b2)} ms/step (host clock, "
              f"synchronised, loader excluded)")
    print(f"three-class training step on host plans, ring aux, batch 1: "
          f"{', '.join(f'{m:.2f}' for m in host_b1)} ms/step; the car "
          f"config's phase-7 host-plans step at batch 2: "
          f"{', '.join(f'{m:.2f}' for m in host_step_ms)} ms/step")
    return runs, per_step


def level_counts(sp, keys0, plans) -> list:
    """Active rows of each level [L0, L1, L2, L3], each a list over the
    rulebook's rows."""
    return [(keys0 != sp.INVALID_KEY).sum(1).tolist()] + [
        (plans[f"coords{lvl}"][..., 0] >= 0).sum(1).tolist()
        for lvl in (1, 2, 3)]


def rulebook_counts(torch, device, cfg, spec, sample_batch):
    """Level counts of a batch's replicated device rulebook and of its
    banded one, and the banded level-0 overflow [S, B]."""
    from sassd_tpu_torch.models import backbone
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    coords = torch.from_numpy(sample_batch["coords"]).to(device)
    shapes = backbone.level_shapes(cfg.sparse_shape)
    keys0 = sp.coords_to_keys(coords, shapes[0])
    rep = level_counts(sp, keys0, sp.device_rulebook(
        keys0, shapes, cfg.caps.level_caps[1:]))
    bc, _, over = ss.partition(coords, torch.zeros(
        coords.shape[:2] + (4,), device=device), spec)
    bshapes = backbone.level_shapes(ss.band_shape(cfg, spec))
    keys0 = sp.coords_to_keys(bc.reshape(-1, bc.shape[2], 3), bshapes[0])
    band = level_counts(sp, keys0, sp.device_rulebook(
        keys0, bshapes, spec.caps[1:],
        y_top=ss.y_top_rows(cfg, spec, coords.shape[0], device)))
    return rep, band, over.tolist()


def check_banded_kernels(torch, np, device, cfg, spec, batch, timing):
    """Phase 9, the kernels of the banded stage at full long-range width
    on the comparison batch (2 scans, 8 band rows): K16 (band partition)
    bitwise against its plain version, also with a fifth of the level-0
    cap, which drops members; K7 with each row's y limit, levels 1-3 of the band
    rulebook, bitwise; K11 with per-row grid origins at levels 1-3: rows,
    weights and output bitwise, its backward within TRAIN_GRAD_RTOL.
    Timed: K16 and K7 (L0 -> L1) on the timing scan (batch 1, 4 band
    rows), K7 replicated (L0 -> L1 of the timing scan, bitwise), K11 at
    batch 2."""
    from sassd_tpu_torch.models import backbone
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.ops.cuda import same_bits
    from sassd_tpu_torch.parallel import sparse_spatial as ss

    def inputs(b):
        coords = torch.from_numpy(b["coords"]).to(device)
        vfe = backbone.vfe_mean(torch.from_numpy(b["voxels"]).to(device),
                                torch.from_numpy(b["num_points"]).to(device))
        return coords, vfe
    rng = np.random.default_rng(SEED + 9)
    coords, vfe = inputs(batch)
    tc, tv = inputs(timing)
    nb = coords.shape[0]
    bshapes = backbone.level_shapes(ss.band_shape(cfg, spec))
    rows = []

    # K16
    err16, over16 = 0.0, {}
    forced = f"cap0 {spec.caps[0] // 5}"
    for what, sp_ in (("caps", spec),
                      (forced, spec._replace(
                          caps=(spec.caps[0] // 5,) + spec.caps[1:]))):
        got = ss.partition(coords, vfe, sp_)
        ref = ss.partition_plain(coords, vfe, sp_)
        same = all(same_bits(g, r) for g, r in zip(got, ref))
        err16 = max([err16] + [float((g.double() - r.double()).abs().max())
                               for g, r in zip(got, ref)])
        over16[what] = got[2].tolist()
        print(f"K16 band_partition {tuple(coords.shape)} -> "
              f"{tuple(got[0].shape)} ({what}): "
              f"{'bitwise equal to' if same else 'DIFFERS from'} plain; "
              f"overflow [S, B] {over16[what]}")
        if not same:
            fail(f"K16 differs from its plain version ({what})")
    if not any(v for r in over16[forced] for v in r):
        fail("K16: the forced-overflow case dropped no member")
    t16 = timed(lambda: ss.partition(tc, tv, spec))
    plain_ms = cuda_ms(lambda: ss.partition_plain(tc, tv, spec))
    print(f"  K16 batch 1 (timing scan): kernel {fmt_timed(t16)}, plain "
          f"{plain_ms:.4f} ms; "
          f"{fmt_split(lambda: ss.partition(tc, tv, spec))}")
    m0, f = tc.shape[1], tv.shape[2]
    n_tv = int((tc[..., 0] >= 0).sum())
    rows.append(dict(name="K16 band_partition", route="cuda",
                     source="sassd_tpu_torch/csrc/band_partition.cu",
                     replaces="sassd_tpu/parallel/sparse_spatial.py:89",
                     max_abs_err=err16, **t16, plain_ms=plain_ms,
                     library_ms=None,
                     library_what="none: a boolean-mask compaction is one "
                                  "call a band and field, without the "
                                  "padding or the cap",
                     at=f"batch 1, the timing scan ({n_tv} voxels), "
                        f"{spec.s} bands, cap0 {spec.caps[0]}",
                     # coords and rows in once; the band arrays and the
                     # overflow out
                     **bound(m0 * (12 + 4 * f)
                             + spec.s * spec.caps[0] * (12 + 4 * f)
                             + spec.s * 4, 0)))

    # K7 with the y limit, levels 1-3 of the comparison batch's bands
    bc, bv, over = ss.partition(coords, vfe, spec)
    cell0 = bc.reshape(spec.s * nb, -1, 3)
    keys = keys0 = sp.coords_to_keys(cell0, bshapes[0])
    y_top = ss.y_top_rows(cfg, spec, nb, device)
    err7, clipped = 0.0, []
    for lvl in (1, 2, 3):
        args = (bshapes[lvl - 1], spec.caps[lvl], y_top >> lvl)
        out = sp.downsample_keys(keys, *args)
        ref = sp.downsample_keys_plain(keys, *args)
        err7 = max(err7, float((out.long() - ref.long()).abs().max()))
        free = sp.downsample_keys(keys, *args[:2])
        clipped.append(int((out != free).any(1).sum()))
        keys = out
    print(f"K7 downsample with y_top, {spec.s * nb} band rows, levels 1-3: "
          f"max|kernel-plain| {err7:g}; rows the limit changed per level "
          f"{clipped}")
    if err7:
        fail("K7 with a y limit differs from its plain version")
    tkeys = sp.coords_to_keys(ss.partition(tc, tv, spec)[0].reshape(
        spec.s, -1, 3), bshapes[0])
    ty = ss.y_top_rows(cfg, spec, 1, device) >> 1
    rows.append(k7_row(torch, sp, tkeys, bshapes[0], spec.caps[1], err7,
                       "K7' downsample_y_top",
                       f"L0 -> L1 of the timing scan's {spec.s} band rows",
                       ty))

    # K7 replicated at long range: L0 -> L1 of the timing scan, batch 1
    rshapes = backbone.level_shapes(cfg.sparse_shape)
    rkeys = sp.coords_to_keys(tc, rshapes[0])
    cap1 = cfg.caps.level_caps[1]
    got = sp.downsample_keys(rkeys, rshapes[0], cap1)
    ref = sp.downsample_keys_plain(rkeys, rshapes[0], cap1)
    err_lr = float((got.long() - ref.long()).abs().max())
    n0 = int((rkeys != sp.INVALID_KEY).sum())
    n1 = int((ref != sp.INVALID_KEY).sum())
    print(f"K7 downsample, long range replicated, L0 -> L1 of the timing "
          f"scan ({n0} voxels -> {n1} rows, cap {cap1}): max|kernel-plain| "
          f"{err_lr:g}")
    if err_lr:
        fail("K7 differs from its plain version at long range")
    rows.append(k7_row(torch, sp, rkeys, rshapes[0], cap1, err_lr,
                       "K7 downsample_long_range",
                       "L0 -> L1 of the long-range timing scan, replicated, "
                       "batch 1"))

    # K11 with per-row origins on the band train rulebook's aux plans
    plans = sp.device_rulebook(keys0, bshapes, spec.caps[1:], train=True,
                               y_top=y_top)
    # K13 at the band rows: the levels' keys and maps of the band rulebook
    bkeys = [keys0] + [sp.coords_to_keys(plans[f"coords{lvl}"], bshapes[lvl])
                       for lvl in (1, 2, 3)]
    bmaps = [sp.build_index_map(k, s) for k, s in zip(bkeys[1:], bshapes[1:])]
    row13 = k13_check(torch, f"banded, batch 2 ({spec.s * nb} band rows), "
                             f"levels 1-3 in one call", bkeys, bmaps, bshapes,
                      [plans[f"stride{lvl}"] for lvl in (1, 2, 3)])
    row13["name"] = "K13 stride_plans_T, banded"
    rows.append(row13)
    del bmaps
    query = bv.reshape(spec.s * nb, -1, bv.shape[-1])[..., :3].contiguous()
    origins = ss.band_origins(cfg, spec, nb, device)
    k11 = {}
    for level, c in ((1, 32), (2, 64), (3, 64)):
        vs = (np.asarray(cfg.voxel.voxel_size, np.float32)
              * 2 ** level).tolist()
        m = spec.caps[level]
        feats = torch.from_numpy(rng.normal(size=(spec.s * nb, m, c)).astype(
            np.float32)).to(device)
        cot = torch.from_numpy(rng.normal(size=query.shape[:2] + (c,)).astype(
            np.float32)).to(device)
        k11[level] = ring_interp_level(torch, " with per-row origins", query,
                                       cell0, level, feats,
                                       plans[f"aux{level}"], vs, origins, cot)
    rows.append(ring_interp_row(
        k11, "K11' ring_interp_origins",
        "sassd_tpu/parallel/sparse_spatial.py:143",
        f"batch 2 ({spec.s * nb} band rows), levels 1-3"))
    return rows


def long_range_inputs(np, root: str, write: bool = True,
                      timing: bool = True, cfgs=None):
    """Phase 9's configs and inputs: the long-range config banded over 4
    y-bands (cfg_b) and replicated on device plans (cfg_r), or the pair
    `cfgs` (phase 12's ranks take the parent's from their job file), the
    band spec, the 4-scan synthetic train split under root (written
    unless `write` is false: phase 12's ranks read the parent's), its
    first two samples and their batch, and the timing scan's batch (None
    unless `timing`)."""
    import dataclasses
    from sassd_tpu_torch.config import ParallelConfig, long_range_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.parallel import sparse_spatial as ss

    if cfgs is None:
        base = long_range_config()
        cfg_b = dataclasses.replace(
            base, parallel=ParallelConfig(strategy="banded", spatial=4),
            train=dataclasses.replace(base.train, log_interval=1,
                                      checkpoint_interval=1),
            data=dataclasses.replace(base.data, num_workers=2))
        cfg_r = dataclasses.replace(cfg_b, parallel=ParallelConfig(),
                                    model=dataclasses.replace(
                                        base.model, host_plans=False))
    else:
        cfg_b, cfg_r = cfgs
    if write:
        synthetic.write_synthetic_kitti(
            root, n_train=N_SCANS, n_val=0, seed=SEED + 9,
            point_cloud_range=cfg_b.voxel.point_cloud_range,
            n_ground=LR_GROUND)
    ds = kitti.KittiDataset(cfg_b, os.path.join(root, "training"),
                            os.path.join(root, "ImageSets", "train.txt"),
                            train=True)
    samples = [ds[i] for i in range(2)]
    if any(k.startswith("plan_") for k in samples[0]):
        fail("long range: host plans built for the banded config")
    t_batch = None
    if timing:
        t_batch = kitti.collate([kitti.prepare_scan(
            cfg_b, synthetic.long_range_scene(
                np.random.default_rng(SEED + 10))[0], ds.anchors_bv)])[0]
    return dict(cfg_b=cfg_b, cfg_r=cfg_r, spec=ss.config_band_spec(cfg_b),
                ds=ds, samples=samples, batch=kitti.collate(samples)[0],
                t_batch=t_batch)


def lr_train_step(torch, device, cfg, state_dict, batch, anchors,
                  perturb: bool = False) -> dict:
    """One long-range forward_train + backward from `state_dict`: the
    losses, the gradients of the objective without the PSWarp loss
    (everything upstream of the guided top-k, see run_long_range) and of
    the full objective, and the BatchNorm running-statistic updates, all
    on the CPU in float64. `perturb`: the voxels one float32 ulp off.
    Under a process group the gradients and losses are summed over the
    ranks as the train step sums them (nothing without one), so every
    rank returns the global step's."""
    from sassd_tpu_torch.inference import to_device
    from sassd_tpu_torch.models.detector import parse_losses
    from sassd_tpu_torch.parallel import dist
    from sassd_tpu_torch.weights import seeded_detector
    model = seeded_detector(cfg, SEED, device)
    model.load_state_dict(state_dict)
    model.train()
    before = {k: v.clone() for k, v in model.named_buffers()
              if k.rsplit(".", 1)[-1] in ("mean", "var")}
    b = to_device(batch, device)
    if perturb:
        b["voxels"] = b["voxels"] * (1.0 + 2.0 ** -23)
    losses = model.forward_train(b, anchors)
    params = dict(model.named_parameters())
    upstream = sum(v for k, v in losses.items()
                   if "loss" in k and k != "loss_cls")
    g_up = torch.autograd.grad(upstream, list(params.values()),
                               retain_graph=True, allow_unused=True)
    g_up = [g if g is not None else torch.zeros_like(p)
            for g, p in zip(g_up, params.values())]
    parse_losses(losses).backward()
    full = [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params.values()]
    values = torch.stack([v.detach() for v in losses.values()])
    dist.all_reduce_coalesced(g_up + full + [values])
    if b["voxels"].is_cuda:
        torch.cuda.synchronize()
    cpu = lambda ts: {k: t.detach().double().cpu()   # noqa: E731
                      for k, t in zip(params, ts)}
    return dict(losses=dict(zip(losses, values.tolist())),
                upstream=cpu(g_up), full=cpu(full),
                bn={k: (v - before[k]).double().cpu()
                    for k, v in model.named_buffers() if k in before})


def grad_diff(res: dict, a: str, b: str, kind: str):
    """(relative norm difference, module rel L2 errors) of the `kind`
    gradients of run b against run a (lr_train_step results)."""
    ga, gb = res[a][kind], res[b][kind]
    norm_a = sum(float((g ** 2).sum()) for g in ga.values()) ** 0.5
    norm_b = sum(float((g ** 2).sum()) for g in gb.values()) ** 0.5
    mods = {}
    for mod in ("vxnet", "bevnet", "head", "pswarp", "aux"):
        mk = [k for k in ga if k.startswith(mod + ".")]
        ref = sum(float((ga[k] ** 2).sum()) for k in mk) ** 0.5
        if ref > 0:
            mods[mod] = sum(float(((gb[k] - ga[k]) ** 2).sum())
                            for k in mk) ** 0.5 / ref
    return abs(norm_b - norm_a) / norm_a, mods


def bn_update_err(res: dict, a: str, b: str) -> float:
    """The largest BatchNorm running-statistic update difference of run b
    against run a, relative to each buffer's largest update."""
    ua, ub = res[a]["bn"], res[b]["bn"]
    return max(float((ub[k] - ua[k]).abs().max()
                     / ua[k].abs().max().clamp(min=1e-12)) for k in ua)


def train_gate(res: dict, a: str, b: str, what: str) -> dict:
    """Phase 9's gates of run b's train step against run a's: every loss
    within TRAIN_LOSS_RTOL, the gradients without the PSWarp loss (norm
    TRAIN_GNORM_RTOL, each module TRAIN_GRAD_L2), the PSWarp module's own
    full gradients (TRAIN_GRAD_L2) and the BatchNorm updates
    (BN_UPDATE_RTOL). Returns the differences; fails on any gate."""
    la, lb = res[a]["losses"], res[b]["losses"]
    # relative differences; a loss of exactly 0 (no positives) must match
    loss_err = {k: (abs(lb[k] - v) / abs(v) if v else
                    (0.0 if lb[k] == v else float("inf")))
                for k, v in la.items() if "loss" in k}
    up_norm, up_mods = grad_diff(res, a, b, "upstream")
    full_norm, full_mods = grad_diff(res, a, b, "full")
    out = dict(losses=max(loss_err.values()), upstream_norm=up_norm,
               upstream_modules=max(up_mods.values()),
               pswarp_full=full_mods["pswarp"],
               bn_update=bn_update_err(res, a, b))
    if not (all(e <= TRAIN_LOSS_RTOL for e in loss_err.values())
            and up_norm <= TRAIN_GNORM_RTOL
            and all(e <= TRAIN_GRAD_L2 for e in up_mods.values())
            and full_mods["pswarp"] <= TRAIN_GRAD_L2
            and out["bn_update"] <= BN_UPDATE_RTOL):
        fail(f"{what}: the train steps disagree: losses {la} vs {lb}; "
             f"largest differences {out}")
    return dict(out, full_norm=full_norm,
                modules={k: float(f"{v:.3g}") for k, v in up_mods.items()})


def run_long_range(torch, np, device, root: str):
    """Phase 9: the long-range config, banded over 4 y-bands against
    replicated (device plans), at full width. Returns (kernel rows,
    launches of banded inference, of replicated inference and of the
    banded train_model run, launches of one banded train step, the
    timings, and the single-process references phase 12 holds its ranks
    to: both scans' batch-1 detections and the batch-2 train step, banded
    and replicated)."""
    import logging
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.train import loop, optim
    from sassd_tpu_torch.weights import seeded_detector

    lr = long_range_inputs(np, root)
    cfg_b, cfg_r, spec, ds, samples, batch, t_batch = (
        lr[k] for k in ("cfg_b", "cfg_r", "spec", "ds", "samples", "batch",
                        "t_batch"))
    rows = check_banded_kernels(torch, np, device, cfg_b, spec, batch,
                                t_batch)
    for what, b in (("comparison scans", batch), ("timing scan", t_batch)):
        rep, band, over = rulebook_counts(torch, device, cfg_b, spec, b)
        print(f"long range, {what}: active rows per level, replicated "
              f"{rep} (caps {list(cfg_b.caps.level_caps)}); banded, "
              f"band-major rows {band} (caps {list(spec.caps)}); level-0 "
              f"band overflow {over}")
        if what == "comparison scans":
            full = [lv for lv, (n, cap) in enumerate(zip(rep, cfg_b.caps
                                                         .level_caps))
                    if max(n) >= cap]
            full += [lv for lv, (n, cap) in enumerate(zip(band, spec.caps))
                     if max(n) >= cap]
            if full or any(v for r in over for v in r):
                fail(f"long range: a comparison scan fills a cap (levels "
                     f"{full}) or overflows a band")

    model_b = seeded_detector(cfg_b, SEED, device)
    model_r = seeded_detector(cfg_r, SEED, device)
    model_r.load_state_dict(model_b.state_dict())
    anchors = torch.from_numpy(ds.anchors).to(device)

    # forward_test, banded then replicated, each scan at batch 1
    b1 = [kitti.collate([s])[0] for s in samples]
    steps = {"banded": (make_test_step(cfg_b, ds.anchors, device), model_b),
             "replicated": (make_test_step(cfg_r, ds.anchors, device),
                            model_r)}
    dets, launches = {}, {}
    for what, (step, model) in steps.items():
        step(model, b1[0])                                # warm-up
        torch.cuda.synchronize()
        reset_launches()
        dets[what] = [{k: v.cpu().numpy() for k, v in step(model, b).items()}
                      for b in b1]
        torch.cuda.synchronize()
        launches[what] = read_launches()
        print(f"long range, {what} inference: launches {launches[what]}")
    counts = [match_detections(dets["banded"][i], dets["replicated"][i],
                               f"long range, scan {i}: banded vs replicated")
              for i in range(len(b1))]
    print(f"long range: banded detections match replicated ones on both "
          f"scans ({counts} detections; boxes {DET_BOX_ATOL}, scores "
          f"{DET_SCORE_ATOL})")

    # one forward_train + backward, banded and replicated, same weights.
    # The guided candidates are a top-k over scores, so a near-tie may
    # flip between two float32 runs and change the PSWarp loss's
    # gradients; the gradients are held to the gates with that loss left
    # out (everything upstream of the top-k), the PSWarp module's own
    # gradients with it. A replicated step on inputs perturbed by one
    # float32 ulp shows how far float32 rounding alone moves them.
    state = model_b.state_dict()
    res = {what: lr_train_step(torch, device, cfg, state, batch, anchors,
                               perturb=what == "perturbed")
           for what, cfg in (("banded", cfg_b), ("replicated", cfg_r),
                             ("perturbed", cfg_r))}

    def fmt(d):
        return {k: float(f"{v:.3g}") for k, v in d.items()}
    bl, rl = res["banded"]["losses"], res["replicated"]["losses"]
    if bl.get("band_overflow") != 0.0:
        fail(f"long range: band_overflow {bl.get('band_overflow')}")
    noise_norm, noise_mods = grad_diff(res, "replicated", "perturbed", "full")
    _, full_mods = grad_diff(res, "replicated", "banded", "full")
    gate = train_gate(res, "replicated", "banded",
                      "long range, banded vs replicated")
    print(f"long range, one train step at batch 2, banded vs replicated: "
          f"losses {dict(sorted(bl.items()))} vs {dict(sorted(rl.items()))}"
          f"; gradients without the PSWarp loss: norm rel diff "
          f"{gate['upstream_norm']:.3g}, module rel L2 {gate['modules']} "
          f"(tol {TRAIN_GNORM_RTOL}, {TRAIN_GRAD_L2}); full objective: norm "
          f"{gate['full_norm']:.3g}, modules {fmt(full_mods)}; a replicated "
          f"step on inputs one ulp off: norm {noise_norm:.3g}, modules "
          f"{fmt(noise_mods)}; largest BN running-stat update difference "
          f"{gate['bn_update']:.3g} of its buffer's largest update")

    # train_model of the banded config: 2 steps at batch 2 (8 band rows)
    logged = []

    class Keep(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())
    logger = logging.getLogger("sassd.chip_smoke.long_range")
    logger.setLevel(logging.INFO)
    logger.addHandler(Keep())
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    model_t, opt, n_steps = loop.train_model(
        cfg_b, ds, os.path.join(root, "work"), total_epochs=1,
        device=device, logger=logger)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches["training"] = read_launches()
    lines = [m for m in logged if " step " in m]
    print(f"long range, banded train_model ran {n_steps} steps in "
          f"{run_s:.1f} s; launches {launches['training']}")
    for m in lines:
        print("  " + m)
    values = [float(kv.split("=")[1]) for m in lines for kv in m.split()
              if "=" in kv]
    if n_steps != N_SCANS // cfg_b.train.batch_size or opt.count != n_steps:
        fail(f"long range: {n_steps} steps, {opt.count} updates applied")
    if len(lines) != n_steps or not np.isfinite(values).all():
        fail("long range: a logged loss or metric is not finite")
    if any("band_overflow=0.0000" not in m
           or "nonfinite_skips=0.0000" not in m for m in lines):
        fail("long range: a step overflowed a band or skipped its update")

    # timings: ms/scan at batch 1 on the timing scan, in turns, and the
    # train step at batch 2, banded and replicated
    ms = {"banded": [], "replicated": []}
    for what in ("banded", "replicated", "replicated", "banded"):
        step, model = steps[what]
        step(model, t_batch)
        torch.cuda.synchronize()
        for _ in range(2):
            t = time.perf_counter()
            step(model, t_batch)
            torch.cuda.synchronize()
            ms[what].append((time.perf_counter() - t) * 1e3)
    train_ms = {}
    for what, cfg, model in (("banded", cfg_b, model_t),
                             ("replicated", cfg_r, model_r)):
        step = loop.make_train_step(cfg, ds.anchors, optim.make_optimizer(
            model, cfg.train, 1000), device)
        train_ms[what] = train_step_ms(torch, step, model, batch)
        if what == "banded":
            reset_launches()
            step(model, batch)
            torch.cuda.synchronize()
            per_step = read_launches()
            for kid in ("K13", "K14"):
                check_once(sp, per_step, "long range, banded training", kid,
                           1)
    refs = dict(dets=dets, steps={k: res[k] for k in ("banded",
                                                       "replicated")},
                inputs=dict(cfg_b=cfg_b, cfg_r=cfg_r, samples=samples,
                            anchors=ds.anchors))
    return rows, launches, per_step, ms, train_ms, refs


# ------------------------------------------------------------ phase 13

def bf16_cfg(cfg):
    """cfg with model.compute_dtype="bfloat16"."""
    import dataclasses
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))


def bf16_err(torch, got, plain, args):
    """A bfloat16 kernel's result against its plain version
    (`plain(*args, compute_dtype)`) summed in float64 on the same inputs:
    the largest |got - plain| over that element's sum of |products| (inf
    where the sum is 0 and got is not), and the largest |got - plain|."""
    from sassd_tpu_torch.ops import sparse as sp
    bf = torch.bfloat16
    ref = plain(*[a.double() if a.is_floating_point() else a for a in args],
                bf)
    scale = plain(*[sp.rounded(a, bf).abs().double()
                    if a.is_floating_point() else a for a in args],
                  torch.float32)
    diff = (got.double() - ref).abs()
    if bool((diff[scale == 0] != 0).any()):
        return float("inf"), float(diff.max())
    return (float((diff / scale.clamp(min=1e-300)).max()),
            float(diff.max()))


def bf16_timed(torch, fn, f32_fn, plain_fn, lib_fn, f32_lib_fn) -> dict:
    """A bfloat16 kernel's whole wrapper call (the rounding of its
    operands included) beside the float32 kernel at the same shape: by CUDA
    events (ms and f32_ms; 3 warm-ups, the mean of 20 calls, in turns
    bfloat16, float32, float32, bfloat16, each the mean of its two
    readings, before any profiling) and by torch.profiler's kernel time
    (profiler_ms and f32_profiler_ms, its parts by kernel name in split and
    f32_split; None when three tries saw fewer than the 10 calls of each
    kernel: the profiler can drop some calls' kernels); the plain version
    (plain_ms) and the one-call yardsticks in bfloat16 (library_ms) and
    float32 (f32_library_ms) by events."""
    turns = [cuda_ms(f) for f in (fn, f32_fn, f32_fn, fn)]

    def profiled(f):
        for _ in range(3):
            counts = {}
            split = kernel_split(f, counts=counts)
            if split and min(counts.values()) >= 10:
                return sum(split.values()), split
        return None, None
    profiler_ms, parts = profiled(fn)
    f32_profiler_ms, f32_parts = profiled(f32_fn)
    return dict(ms=(turns[0] + turns[3]) / 2, profiler_ms=profiler_ms,
                split=parts, f32_ms=(turns[1] + turns[2]) / 2,
                f32_profiler_ms=f32_profiler_ms, f32_split=f32_parts,
                plain_ms=cuda_ms(plain_fn), library_ms=cuda_ms(lib_fn),
                f32_library_ms=cuda_ms(f32_lib_fn))


def fmt_parts(t: dict) -> str:
    """bf16_timed's profiler split, as text."""
    if t["split"] is None:
        return "profiler split not measured"
    return "profiler split " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in t["split"].items())


def fmt_opt(ms) -> str:
    """A reading in ms, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f}"


def bf16_row(parts: list) -> dict:
    """The per-scan (or per-step) sums of bf16_timed's shapes, each
    (name, convs, err, abs err, timed, found fraction, bound); a sum with
    a reading not measured is None."""
    out = {k: (None if any(t[k] is None for _, _, _, _, t, _, _ in parts)
               else sum(n * t[k] for _, n, _, _, t, _, _ in parts))
           for k in ("ms", "profiler_ms", "f32_ms", "f32_profiler_ms",
                     "plain_ms", "library_ms", "f32_library_ms")}
    out.update(add_bounds([bd for _, n, *_, bd in parts for _ in range(n)],
                          BF16_FLOPS))
    out["max_sum_rel_err"] = max(e for _, _, e, *_ in parts)
    out["max_abs_err"] = max(e for _, _, _, e, *_ in parts)
    out["per_shape"] = {name: dict(convs=n, sum_rel_err=e, **t,
                                   found_frac=ff, **bd)
                        for name, n, e, _, t, ff, bd in parts}
    return out


def check_bf16_kernels(torch, np, device, cfg, samples, train_samples):
    """Phase 13a: K4-bf16 at batch 1 on scan 0's host plans (the ladder's
    10 convs), its input gradients at batch 2 on the train plans (9 convs
    and the PointNet VFE's 4-wide input), K10-bf16 at batch 2 (10 convs),
    each against its plain version summed in float64 (BF16_SUM_RTOL of
    each element's sum of |products|) and bitwise equal over two calls;
    timed beside K4 / K10 at the same shapes, the plain versions and one
    torch.matmul of the gathered im2col (not timed) in bfloat16 and in
    float32; then K4-bf16 on the edge cases of its compaction at car
    shapes (bf16_edge_cases)."""
    from sassd_tpu_torch.ops import sparse as sp
    bf = torch.bfloat16
    rng = np.random.default_rng(SEED + 13)
    caps = (cfg.voxel.max_voxels,) + tuple(cfg.caps.level_caps[1:])
    s0 = {k: torch.from_numpy(v[None]).to(device)
          for k, v in samples[0].items() if k != "meta"}
    batch = {k: torch.from_numpy(np.stack([s[k] for s in train_samples[:2]]))
             .to(device) for k in train_samples[0] if k != "meta"}

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(device)

    def col_of(x, plan):
        b, m_in, c = x.shape
        return sp.gather_im2col(x.reshape(b * m_in, c), sp.flatten_plan(
            sp.host_plan(plan), m_in))

    def check(name, what, err):
        if not err[0] <= BF16_SUM_RTOL:
            fail(f"{what} disagrees with its plain version on {name}: "
                 f"{err[0]:.3g} of the sum of |products|")

    def repeats(name, what, got, again):
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            fail(f"{what} gives two different results on {name}")

    def fmt_t(t, f32_name):
        return (f"kernel {t['ms']:.4f} ms (profiler "
                f"{fmt_opt(t['profiler_ms'])}; {fmt_parts(t)}), {f32_name} "
                f"float32 {t['f32_ms']:.4f} (profiler "
                f"{fmt_opt(t['f32_profiler_ms'])}), plain "
                f"{t['plain_ms']:.4f}, matmul of the im2col bf16 "
                f"{t['library_ms']:.4f}, float32 {t['f32_library_ms']:.4f}")

    fwd, dx, dw = [], [], []
    for name, plan_key, level_in, cin, cout, mult in LADDER:
        # K4-bf16, batch 1, the forward
        plan = s0[plan_key]
        x = randn(1, caps[level_in], cin)
        w = randn(27, cin, cout, scale=1 / np.sqrt(27 * cin))
        got = sp.subm_conv_batched(x, w, plan, bf)
        repeats(name, "K4-bf16", got, sp.subm_conv_batched(x, w, plan, bf))
        err = bf16_err(torch, got, sp.subm_conv_batched_plain, (x, w, plan))
        check(name, "K4-bf16", err)
        col, w2 = col_of(x, plan), w.reshape(27 * cin, cout)
        col16, w16 = col.to(bf), w2.to(bf)
        t = bf16_timed(
            torch, lambda: sp.subm_conv_batched(x, w, plan, bf),
            lambda: sp.subm_conv_batched(x, w, plan),
            lambda: sp.subm_conv_batched_plain(x, w, plan, bf),
            lambda: torch.matmul(col16, w16), lambda: torch.matmul(col, w2))
        found = int((plan >= 0).sum())
        bd = bound(x.numel() * 4 + plan.numel() * plan.element_size()
                   + w.numel() * 4 + plan.shape[2] * cout * 4,
                   2 * found * cin * cout, BF16_FLOPS)
        print(f"K4-bf16 sparse_conv {name} x{mult} {cin}->{cout}: "
              f"|kernel-plain| <= {err[0]:.3g} of the sum of |products| "
              f"(tol {BF16_SUM_RTOL}), max abs {err[1]:.3g}, two calls "
              f"bitwise equal; {fmt_t(t, 'K4')}, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        fwd.append((name, mult, err[0], err[1], t, found / plan.numel(), bd))

        # batch 2 on the train plans: K10-bf16 and K4-bf16's input gradient
        plan = batch[plan_key]
        x = randn(2, caps[level_in], cin)
        cot = randn(2, plan.shape[2], cout)
        got = sp.conv_weight_grad(x, plan, cot, bf)
        repeats(name, "K10-bf16", got, sp.conv_weight_grad(x, plan, cot, bf))
        err = bf16_err(torch, got, sp.conv_weight_grad_plain, (x, plan, cot))
        check(name, "K10-bf16", err)
        col, d2 = col_of(x, plan), cot.reshape(-1, cout)
        col16, d16 = col.to(bf), d2.to(bf)
        t = bf16_timed(
            torch, lambda: sp.conv_weight_grad(x, plan, cot, bf),
            lambda: sp.conv_weight_grad(x, plan, cot),
            lambda: sp.conv_weight_grad_plain(x, plan, cot, bf),
            lambda: torch.matmul(col16.T, d16),
            lambda: torch.matmul(col.T, d2))
        found = int((plan >= 0).sum())
        bd = bound(x.numel() * 4 + cot.numel() * 4
                   + plan.numel() * plan.element_size() + got.numel() * 4,
                   2 * found * cin * cout, BF16_FLOPS)
        print(f"K10-bf16 conv_weight_grad {name} x{mult} {cin}->{cout}: "
              f"{err[0]:.3g} of the sum of |products| (tol "
              f"{BF16_SUM_RTOL}), two calls bitwise equal; "
              f"{fmt_t(t, 'K10')}, bound {bd['bound_ms']:.4f} ms "
              f"({bd['bound_by']})")
        dw.append((name, mult, err[0], err[1], t, found / plan.numel(), bd))

        # the input gradient: the subm plan with the taps reversed and the
        # weight transposed (the 4-wide input padded to 16 columns), or the
        # stride conv's transpose plan with the weight transposed
        if plan_key.startswith("plan_subm"):
            dx_plan, w_dx = plan, sp.input_grad_weight(w)
        else:
            dx_plan = batch["plan_strideT" + plan_key[-1]]
            w_dx = w.transpose(1, 2)
        w_dx = w_dx.contiguous()
        if plan_key.startswith("plan_subm"):
            fn = lambda: sp._subm_input_grad(cot, w, plan, bf)  # noqa: E731
        else:
            fn = lambda: sp.subm_conv_batched(  # noqa: E731
                cot, w.transpose(1, 2), dx_plan, bf)
        got = fn()
        repeats(name, "K4-bf16's input gradient", got, fn())
        err = bf16_err(torch, got, lambda c, ww, p, cd: (
            sp.subm_conv_batched_plain(c, ww, p, cd)[..., :cin]),
            (cot, w_dx, dx_plan))
        check(name, "K4-bf16's input gradient", err)
        col, w2 = col_of(cot, dx_plan), w_dx.reshape(-1, w_dx.shape[2])
        col16, w16 = col.to(bf), w2.to(bf)
        t = bf16_timed(
            torch, fn,
            lambda: sp.subm_conv_batched(cot, w_dx, dx_plan),
            lambda: sp.subm_conv_batched_plain(cot, w_dx, dx_plan, bf),
            lambda: torch.matmul(col16, w16), lambda: torch.matmul(col, w2))
        found = int((dx_plan >= 0).sum())
        bd = bound(cot.numel() * 4 + dx_plan.numel() * dx_plan.element_size()
                   + w_dx.numel() * 4 + x.numel() * 4,
                   2 * found * cout * w_dx.shape[2], BF16_FLOPS)
        what = ("the PointNet VFE's 4-wide input, 16 columns" if cin == 4
                else "the subm plan" if dx_plan is plan else "strideT")
        print(f"  K4-bf16 input gradient {name} x{mult} on {what} "
              f"{cout}->{cin}: {err[0]:.3g} of the sum of |products|, two "
              f"calls bitwise equal; {fmt_t(t, 'K4')}, bound "
              f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        dx.append((name, mult, err[0], err[1], t, found / dx_plan.numel(),
                   bd))
    edge = bf16_edge_cases(torch, np, device, caps, s0, batch, rng)
    lib = ("torch.matmul of the gathered bfloat16 im2col by the bfloat16 "
           "weight (the gather not timed); f32_library_ms: the same in "
           "float32, TF32 off, K4's yardstick")
    fwd_row, dw_row = bf16_row(fwd), bf16_row(dw)
    dx_row = bf16_row([p for p in dx if p[0] != "conv0.0"])
    return [
        dict(name="K4-bf16 sparse_conv", route="cuda",
             source="sassd_tpu_torch/csrc/sparse_conv.cu",
             replaces="sassd_tpu/ops/sparse.py:511",
             err_kind="abs; each element within BF16_SUM_RTOL of its sum "
                      "of |products| (max_sum_rel_err); two calls bitwise "
                      "equal",
             library_what=lib,
             at="batch 1, one scan's forward: the ladder's 10 convs, "
                "launches x ms summed, each the whole wrapper call (the "
                "bfloat16 copy and panel included); f32_ms is K4 at the "
                "same shapes",
             input_grad=dict(
                 dx_row, pointnet_4wide=dict(
                     sum_rel_err=dx[0][2], **dx[0][4], **dx[0][6]),
                 at="batch 2, the 9 convs whose input takes a gradient, "
                    "launches x ms summed; pointnet_4wide: the PointNet "
                    "VFE's input gradient at subm0 (not in the sums)"),
             edge_cases=edge,
             **fwd_row),
        dict(name="K10-bf16 conv_weight_grad", route="cuda",
             source="sassd_tpu_torch/csrc/sparse_conv_bwd.cu",
             replaces="sassd_tpu/ops/sparse.py:541",
             err_kind="abs; each element within BF16_SUM_RTOL of its sum "
                      "of |products| (max_sum_rel_err); two calls bitwise "
                      "equal",
             library_what=lib.replace("by the bfloat16 weight",
                                      "transposed by the bfloat16 d_out")
                             .replace("K4's", "K10's"),
             at="batch 2, one train step's weight gradients: the ladder's "
                "10 convs, launches x ms summed, each the whole wrapper "
                "call (the bfloat16 copies included); f32_ms is K10 at the "
                "same shapes",
             **dw_row)]


def bf16_edge_cases(torch, np, device, caps, s0, batch, rng) -> dict:
    """K4-bf16 at car shapes on the edge cases of its compaction into
    16-row groups of one tap, on int16 and int32 plans: rows 64..127
    finding nothing (tiles of no found row), tap 5 found in one row only,
    every tap found in every row (random input rows), M cut by 27 rows (a
    ragged last tile); Cin 4 (the mean VFE's input) and the PointNet VFE's 4-wide input
    gradient among them. Each within BF16_SUM_RTOL of the sum of
    |products| of its plain version in float64 and bitwise equal over two
    calls, or the run fails. Returns each case's largest error."""
    from sassd_tpu_torch.ops import sparse as sp
    bf = torch.bfloat16
    out = {}
    for case, plan_key, level_in, cin, cout, src in (
            ("empty_tile", "plan_subm0", 0, 4, 16, s0),
            ("tap_in_one_row", "plan_subm1", 1, 32, 32, s0),
            ("every_tap_every_row", "plan_subm2", 2, 64, 64, s0),
            ("every_tap_every_row", "plan_subm0", 0, 4, 16, batch),
            ("ragged_m_out", "plan_stride2", 1, 32, 64, batch),
            ("ragged_m_out", "plan_strideT3", 3, 64, 64, batch),
            ("pointnet_dx", "plan_subm0", 0, 16, 4, batch)):
        for dtype in (torch.int16, torch.int32):
            plan = src[plan_key].to(dtype).clone()
            b = plan.shape[0]
            if case == "empty_tile":
                plan[..., 64:128] = -1
            elif case == "tap_in_one_row":
                plan[:, 5] = -1
                plan[0, 5, 70] = 3
            elif case == "every_tap_every_row":
                plan = torch.from_numpy(rng.integers(
                    0, caps[level_in], size=tuple(plan.shape))).to(
                    device=device, dtype=dtype)
            elif case == "ragged_m_out":
                plan = plan[..., :plan.shape[2] - 64 + 37].contiguous()
            x = torch.from_numpy(rng.normal(size=(b, caps[level_in], cin))
                                 .astype(np.float32)).to(device)
            w = torch.from_numpy((rng.normal(size=(27, cin, cout))
                                  / np.sqrt(27 * cin)).astype(np.float32)
                                 ).to(device)
            if case == "pointnet_dx":
                # d_out [B, M, 16] -> d_feats [B, M, 4]: x is d_out here
                w = w.transpose(1, 2).contiguous()         # [27, 4, 16]
                fn = lambda: sp._subm_input_grad(x, w, plan, bf)  # noqa
                args = (x, sp.input_grad_weight(w).contiguous(), plan)

                def plain(c, ww, p, cd):
                    return sp.subm_conv_batched_plain(c, ww, p, cd)[..., :4]
            else:
                fn = lambda: sp.subm_conv_batched(x, w, plan, bf)  # noqa
                args, plain = (x, w, plan), sp.subm_conv_batched_plain
            before = read_launches()["sassd_sparse_conv_bf16"]
            got, again = fn(), fn()
            torch.cuda.synchronize()
            if read_launches()["sassd_sparse_conv_bf16"] != before + 2:
                fail(f"K4-bf16 on {case}: not one launch a call")
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                fail(f"K4-bf16 gives two different results on {case}")
            err = bf16_err(torch, got, plain, args)
            if not err[0] <= BF16_SUM_RTOL:
                fail(f"K4-bf16 disagrees with its plain version on {case} "
                     f"({plan_key}, {dtype}): {err[0]:.3g} of the sum of "
                     f"|products|")
            if case == "empty_tile" and bool(got[:, 64:128].any()):
                fail("K4-bf16 writes a nonzero row in a tile of no found row")
            key = f"{case} {plan_key[5:]} {str(dtype)[6:]}"
            out[key] = err[0]
            print(f"  K4-bf16 edge case {key} {tuple(plan.shape)}: "
                  f"{err[0]:.3g} of the sum of |products|, two calls bitwise "
                  f"equal")
    return out


def bf16_match(a, b):
    """Two detection sets (dicts of numpy, one sample) matched greedily
    within BF16_BOX_ATOL and BF16_SCORE_ATOL: (matched, unmatched, the
    largest box and score gaps of the matched pairs); a detection of
    either set without a partner counts as unmatched."""
    import numpy as np
    va, vb = a["valid"], b["valid"]
    ba, sa = a["boxes"][va], a["scores"][va]
    bb, sb = b["boxes"][vb], b["scores"][vb]
    used = np.zeros(len(bb), bool)
    gaps = [0.0, 0.0]
    for i in range(len(ba)):
        d = np.abs(bb - ba[i]).max(1)
        ds = np.abs(sb - sa[i])
        ok = (d <= BF16_BOX_ATOL) & (ds <= BF16_SCORE_ATOL) & ~used
        if ok.any():
            j = int(np.argmax(np.where(ok, -(d + ds), -np.inf)))
            used[j] = True
            gaps = [max(gaps[0], float(d[j])), max(gaps[1], float(ds[j]))]
    n = int(used.sum())
    return n, max(len(ba), len(bb)) - n, gaps[0], gaps[1]


def bf16_dets_gate(got, ref, control, what: str) -> str:
    """A bfloat16 run's detections against a reference run's: the same
    set, each within BF16_BOX_ATOL and BF16_SCORE_ATOL (bf16_match, none
    unmatched), where a float32 run's (`control`) must not be. Fails
    otherwise; returns the printed numbers."""
    m, u, gb, gs = bf16_match(got, ref)
    _, uc, _, _ = bf16_match(control, ref)
    text = (f"{m} detections matched (boxes {BF16_BOX_ATOL}, scores "
            f"{BF16_SCORE_ATOL}; largest gaps {gb:.3g}, {gs:.3g}), {u} "
            f"unmatched; the float32 run leaves {uc} unmatched")
    if u or not uc:
        fail(f"{what}: {text}")
    return text


def bf16_points():
    """tests/torch_bf16_points.py: the port's bfloat16 rounding points."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_bf16_points
    return torch_bf16_points


BF16_BACKWARD = (".g", ".dx", ".dw")      # points of the backward pass


def bf16_forced(torch, what: str, card_run, cpu_run):
    """A bfloat16 run on the card with its rounding points recorded (the
    port's own convs: K4-bf16, K10-bf16, cuDNN), then the same run on the
    CPU with every tie set to the card's neighbour (tests/
    torch_bf16_points.py; a tie lies within BF16_SUM_RTOL of its sum of
    |products| from the midpoint at a dense conv's own outputs, within
    BF16_TIE_RTOL of its tensor's largest magnitude elsewhere): fed the
    card's rounded values wherever the float32 sums' order alone splits
    them, each forward point must round every other value as the card
    did (fails otherwise). The backward's points are forced at ties too,
    but the float32 differences reaching them pass train-mode BatchNorm's
    backward, which amplifies them past any tie (as between a float32
    card step and a float64 one): their values apart are printed.
    Returns (card result, CPU result, the card's points)."""
    bp = bf16_points()
    card = bp.Points()
    with bp.patch(card, twin=False):
        got = card_run()
    torch.cuda.synchronize()
    cpu = bp.Points(ref=card.seen, tol=BF16_TIE_RTOL, sum_tol=BF16_SUM_RTOL)
    t = time.perf_counter()
    with bp.patch(cpu, twin=True):
        ref = cpu_run()
    cpu_s = time.perf_counter() - t
    if cpu.seen.keys() != card.seen.keys():
        fail(f"{what}: the card and the CPU took different rounding points")
    total = sum(v.numel() for v in card.seen.values())
    forced = sum(int(m.sum()) for m in cpu.forced.values())
    apart = {k: v for k, v in cpu.apart.items() if v[0]}
    fwd = {k: v for k, v in apart.items() if not k.endswith(BF16_BACKWARD)}
    bwd = {k: v for k, v in apart.items() if k.endswith(BF16_BACKWARD)}
    print(f"{what}: {len(card.seen)} rounding points, {total} values; the "
          f"CPU's run ({cpu_s:.1f} s) forced to the card's neighbour at "
          f"{forced} ties; rounded apart and no tie: forward "
          f"{sum(n for n, _ in fwd.values())} values, backward "
          f"{sum(n for n, _ in bwd.values())} at {len(bwd)} points (gap up "
          f"to {max([g for _, g in bwd.values()], default=0.0):.3g})")
    if fwd:
        for k, (n, gap) in fwd.items():
            print(f"  {what}: {k}: {n} of {card.seen[k].numel()} values "
                  f"apart, gap up to {gap:.3g}")
        fail(f"{what}: forward values rounded apart from the card's with "
             f"no tie at {sorted(fwd)}")
    return got, ref, card


def bf16_dense_check(torch, device, card) -> str:
    """Each bfloat16 dense conv of a card run recorded by bf16_forced, fed
    its own recorded operands (input, weight, output gradient): its
    output, input gradient and weight gradient as cuDNN gave them must
    each be the exact conv of the rounded operands (float64 on the card)
    rounded to bfloat16, or the other neighbour within BF16_SUM_RTOL of
    the sum of |products| from the midpoint (BF16_WGRAD_RTOL for the
    weight gradient); the same convs in float32 (TF32 off) must fail.
    Returns the printed numbers."""
    import torch.nn.functional as F
    from sassd_tpu_torch.models import layers
    bp = bf16_points()
    grad = torch.nn.grad

    def back(name, perm):
        return card.seen[name].permute(*perm).contiguous().to(device)

    def apart(got, exact, sums, tol):
        """The values not bfloat16 or rounded apart from the exact value
        with no tie, and the largest such gap (`tie_gap`)."""
        gap = bp.tie_gap(exact.float(), got, sums.float())
        far = (gap > tol) & torch.isfinite(gap)
        return (int(((got != bp.rne(got)) | far).sum()),
                float(gap[far].max()) if bool(far.any()) else 0.0)
    n16 = n32 = values = 0
    nchw, oihw = (0, 3, 1, 2), (3, 2, 0, 1)
    for name, (w, pad) in card.convs.items():
        x, g = back(name + ".x", nchw), back(name + ".g", nchw)
        xr, wr, gr = (bp.rne(v).double() for v in (x, w, g))
        exact = (F.conv2d(xr, wr, padding=pad),
                 grad.conv2d_input(xr.shape, wr, gr, padding=pad),
                 grad.conv2d_weight(xr, wr.shape, gr, padding=pad))
        sums = (F.conv2d(xr.abs(), wr.abs(), padding=pad),
                grad.conv2d_input(xr.shape, wr.abs(), gr.abs(), padding=pad),
                grad.conv2d_weight(xr.abs(), wr.shape, gr.abs(),
                                   padding=pad))
        got = (back(name + ".y", nchw), back(name + ".dx", nchw),
               back(name + ".dw", oihw))
        x32, w32 = x.clone().requires_grad_(), w.clone().requires_grad_()
        y32 = layers.conv2d_oihw(x32, w32, None, pad)
        y32.backward(g)
        for what, v16, v32, e, sm, tol in zip(
                (".y", ".dx", ".dw"), got, (y32.detach(), x32.grad, w32.grad),
                exact, sums, (BF16_SUM_RTOL,) * 2 + (BF16_WGRAD_RTOL,)):
            (a16, gap), (a32, _) = (apart(v16, e, sm, tol),
                                    apart(v32, e, sm, tol))
            if a16:
                print(f"  bf16 dense convs: {name}{what} {tuple(v16.shape)}: "
                      f"{a16} values apart, gap up to {gap:.3g}")
            n16, n32, values = n16 + a16, n32 + a32, values + v16.numel()
    text = (f"{len(card.convs)} bfloat16 dense convs fed the card's own "
            f"operands: {n16} of {values} outputs and gradients apart from "
            f"the exact conv rounded (tie {BF16_SUM_RTOL} of the sum of "
            f"|products|, {BF16_WGRAD_RTOL} for weight gradients); the "
            f"float32 convs {n32} apart")
    if n16 or not n32:
        fail(f"bf16 dense convs: {text}")
    return text


BF16_SERVE_IDS = "K1 K2 K3 K4-bf16 K5 K6 K7 K8 K9"
BF16_TRAIN_IDS = "K1 K3 K3b K4-bf16 K5 K5b K6 K7 K10-bf16 K11 K12 K13 K14"


def run_bf16(torch, np, device, cfg, root: str, samples, train_ref: dict,
             lr_ref: dict):
    """Phase 13 b-e (see the module docstring): returns (launches of each
    bfloat16 run, launches of one serving and one train step, the
    timings)."""
    import dataclasses
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step, to_device
    from sassd_tpu_torch.models.detector import parse_losses
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.train import loop, optim
    from sassd_tpu_torch.weights import seeded_detector
    t0 = time.perf_counter()
    cfg16 = bf16_cfg(cfg)
    launches, per_step = {}, {}
    f32_symbols = sp.KERNEL_SYMBOLS["K4"] + sp.KERNEL_SYMBOLS["K10"]

    def counted(what, ids):
        launches[what] = read_launches()
        check_launched(launches[what], ids, f"bf16 {what}")
        used = {s: launches[what][s] for s in f32_symbols
                if launches[what][s]}
        if used:
            fail(f"bf16 {what}: a float32 sparse conv kernel launched: "
                 f"{used}")

    def host(d):
        return {k: v.cpu().numpy() for k, v in d.items()}

    def nonzero(counts):
        return {k: v for k, v in counts.items() if v}

    def finite(dets, what):
        for d in dets:
            if not (np.isfinite(d["boxes"]).all()
                    and np.isfinite(d["scores"]).all()):
                fail(f"bf16 {what}: non-finite detections")

    # (b) forward_test on host plans, and serving raw points: the card
    # against the CPU forced to its ties, a float32 card run as control
    model = seeded_detector(cfg16, SEED, device)
    model_cpu = seeded_detector(cfg16, SEED, "cpu")
    model32 = seeded_detector(cfg, SEED, device)
    anchors = kitti.build_anchors(cfg16)[0]
    step = make_test_step(cfg16, anchors, device)
    cpu_step = make_test_step(cfg16, anchors, "cpu")
    batch1 = [kitti.collate([s])[0] for s in samples[:2]]
    step(model, batch1[0])
    torch.cuda.synchronize()
    reset_launches()
    dets = [host(step(model, b)) for b in batch1]
    torch.cuda.synchronize()
    counted("host plans", "K1 K2 K3 K4-bf16 K5")
    finite(dets, "host plans")
    got, cpu, _ = bf16_forced(
        torch, "bf16 host plans, scan 0",
        lambda: host(step(model, batch1[0])),
        lambda: host(cpu_step(model_cpu, batch1[0])))
    control = host(make_test_step(cfg, anchors, device)(model32, batch1[0]))
    text = bf16_dets_gate(got, cpu, control, "bf16 host plans, scan 0: "
                                             "card vs CPU")
    print(f"bf16 host plans, scan 0: card vs CPU bfloat16 forced to its "
          f"ties: {text}; launches {nonzero(launches['host plans'])}")

    cfg_pts, ds, sstep, sb1, _ = serving_split(torch, np, device, cfg16,
                                               os.path.join(root, "val"))
    sstep(model, sb1[0])
    torch.cuda.synchronize()
    reset_launches()
    sdets = [host(sstep(model, b)) for b in sb1]
    torch.cuda.synchronize()
    counted("serving", BF16_SERVE_IDS)
    finite(sdets, "serving")
    reset_launches()
    sstep(model, sb1[0])
    torch.cuda.synchronize()
    per_step["serving"] = read_launches()
    cpu_sstep = serve.make_serving_step(cfg_pts, ds.anchors, ds.anchors_bv,
                                        "cpu")
    sstep32 = serve.make_serving_step(
        dataclasses.replace(cfg_pts, model=cfg.model), ds.anchors,
        ds.anchors_bv, device)
    got, cpu, _ = bf16_forced(
        torch, "bf16 serving, scan 0",
        lambda: host(sstep(model, sb1[0])),
        lambda: host(cpu_sstep(model_cpu, sb1[0])))
    text = bf16_dets_gate(got, cpu, host(sstep32(model32, sb1[0])),
                          "bf16 serving, scan 0: card vs CPU")
    print(f"bf16 serving (device_input=\"points\"), scan 0: card vs CPU "
          f"bfloat16 forced to its ties: {text}; launches "
          f"{nonzero(launches['serving'])}")

    # (c) one train step at batch 2 on device plans (ring aux), card vs
    # the CPU forced to its ties, a float32 card step as control; each
    # module's distance from phase 7's float64 step
    cfg_d = dataclasses.replace(cfg16, model=dataclasses.replace(
        cfg16.model, host_plans=False))
    batch = {k: v for k, v in train_ref["batch"].items()
             if not k.startswith("plan_")}
    at = train_ref["anchors"]

    def train_step(c, where):
        m = seeded_detector(c, SEED, where)
        m.train()
        losses = m.forward_train(to_device(batch, where), at.to(where))
        parse_losses(losses).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {k: p.grad.detach().cpu().double()
                 for k, p in m.named_parameters()})
    torch.cuda.synchronize()
    reset_launches()
    res = {}
    res["card"], res["cpu"], card_pts = bf16_forced(
        torch, "bf16 training", lambda: train_step(cfg_d, device),
        lambda: train_step(cfg_d, "cpu"))
    counted("training", BF16_TRAIN_IDS)
    per_step["training"] = launches["training"]
    print(f"bf16 training: launches {nonzero(launches['training'])}")
    print(f"bf16 training: {bf16_dense_check(torch, device, card_pts)}")
    del card_pts
    res["card32"] = train_step(dataclasses.replace(cfg_d, model=cfg.model),
                               device)
    g64 = train_ref["g64"]
    keys = list(res["cpu"][1])

    def gnorm(g, ks):
        return sum(float(torch.sum(g[k] ** 2)) for k in ks) ** 0.5

    def gdist(g, ref, ks):
        return (sum(float(torch.sum((g[k] - ref[k]) ** 2)) for k in ks)
                ** 0.5 / max(gnorm(ref, ks), 1e-300))

    def gates(name):
        """The card step `name` against the CPU's bfloat16 step: the
        losses that fail BF16_LOSS_RTOL, the gradient norm and the modules
        that fail BF16_GNORM_RTOL (relative L2)."""
        (gl, ggr), (cl, cgr) = res[name], res["cpu"]
        bad = [k for k, v in cl.items() if "loss" in k and not (
            np.isfinite(gl[k]) and abs(gl[k] - v) <= BF16_LOSS_RTOL * abs(v))]
        if (abs(gnorm(ggr, keys) - gnorm(cgr, keys))
                > BF16_GNORM_RTOL * gnorm(cgr, keys)):
            bad.append("the gradient norm")
        for mod in BF16_MODULES:
            mk = [k for k in keys if k.startswith(mod + ".")]
            if gdist(ggr, cgr, mk) > BF16_GNORM_RTOL:
                bad.append(f"the {mod} gradients")
        return bad
    for k, v in sorted(res["cpu"][0].items()):
        print(f"bf16 training, card vs CPU bfloat16: {k} "
              f"{res['card'][0][k]:.7g} vs {v:.7g} (float32 card "
              f"{res['card32'][0][k]:.7g})")
    print(f"bf16 training: grad norm card {gnorm(res['card'][1], keys):.7g}, "
          f"CPU {gnorm(res['cpu'][1], keys):.7g}, float32 card "
          f"{gnorm(res['card32'][1], keys):.7g}, float64 CPU "
          f"{gnorm(g64, keys):.7g}")
    dist64 = {}
    for mod in BF16_MODULES:
        mk = [k for k in keys if k.startswith(mod + ".")]
        dist64[mod] = tuple(gdist(res[n][1], g64, mk)
                            for n in ("card", "cpu", "card32"))
        print(f"bf16 training: {mod} gradients, card vs CPU rel L2 "
              f"{gdist(res['card'][1], res['cpu'][1], mk):.3g} (float32 "
              f"card {gdist(res['card32'][1], res['cpu'][1], mk):.3g}); "
              f"rel L2 from the float64 step: bfloat16 card "
              f"{dist64[mod][0]:.3g}, bfloat16 CPU {dist64[mod][1]:.3g}, "
              f"float32 card {dist64[mod][2]:.3g}")
    bad = gates("card")
    if bad:
        fail(f"bf16 training: card and CPU disagree on {bad}")
    if not gates("card32"):
        fail("bf16 training: the float32 card step passes the bfloat16 "
             "gates")

    # (d) the long-range banded config, one forward_test at batch 1 on
    # each of phase 9's comparison scans against replicated (both on the
    # card), a float32 replicated run as control
    cfg_b, cfg_r = bf16_cfg(lr_ref["cfg_b"]), bf16_cfg(lr_ref["cfg_r"])
    model_b = seeded_detector(cfg_b, SEED, device)
    model_r = seeded_detector(cfg_r, SEED, device)
    model_r.load_state_dict(model_b.state_dict())
    model_r32 = seeded_detector(lr_ref["cfg_r"], SEED, device)
    model_r32.load_state_dict(model_b.state_dict())
    lb = [kitti.collate([s])[0] for s in lr_ref["samples"][:2]]
    step_b = make_test_step(cfg_b, lr_ref["anchors"], device)
    step_r = make_test_step(cfg_r, lr_ref["anchors"], device)
    step_r32 = make_test_step(lr_ref["cfg_r"], lr_ref["anchors"], device)
    step_b(model_b, lb[0])
    torch.cuda.synchronize()
    reset_launches()
    bdets = [host(step_b(model_b, b)) for b in lb]
    torch.cuda.synchronize()
    counted("long range, banded", "K1 K2 K3 K4-bf16 K5 K6 K16 K7'")
    rdets = [host(step_r(model_r, b)) for b in lb]
    finite(bdets + rdets, "long range")
    for i in range(len(lb)):
        text = bf16_dets_gate(bdets[i], rdets[i],
                              host(step_r32(model_r32, lb[i])),
                              f"bf16 long range, scan {i}: banded vs "
                              f"replicated")
        print(f"bf16 long range, scan {i}: banded vs replicated: {text}")
    print(f"bf16 long range: banded launches "
          f"{nonzero(launches['long range, banded'])}")

    # (e) steps in both dtypes, in turns: serving at batch 1 (raw points
    # uploaded in the step) and the train step at batch 2 (host plans)
    serve_ms = {"float32": [], "bfloat16": []}
    for what in ("float32", "bfloat16", "bfloat16", "float32"):
        st, m = (sstep32, model32) if what == "float32" else (sstep, model)
        st(m, sb1[0])
        torch.cuda.synchronize()
        for b in sb1[:2]:
            t = time.perf_counter()
            st(m, b)
            torch.cuda.synchronize()
            serve_ms[what].append((time.perf_counter() - t) * 1e3)
    train_ms = {"float32": [], "bfloat16": []}
    for what in ("float32", "bfloat16", "bfloat16", "float32"):
        c = cfg if what == "float32" else cfg16
        m = seeded_detector(c, SEED, device)
        st = loop.make_train_step(c, anchors, optim.make_optimizer(
            m, c.train, 1000), device)
        train_ms[what] += train_step_ms(torch, st, m, train_ref["batch"],
                                        n=2)
    wall = time.perf_counter() - t0
    print(f"bf16: phase 13 b-e took {wall:.1f} s")
    return launches, per_step, dict(serve_ms=serve_ms, train_ms=train_ms,
                                    dist64=dist64, wall_s=wall)


# ------------------------------------------------------------ phase 14

def level_keys(cfg, coords):
    """The keys of the three plan-building levels of [1, cap0, 3] coords,
    on their device (K7 between levels), as the persistent rulebook makes
    them."""
    from sassd_tpu_torch.models.backbone import level_shapes
    from sassd_tpu_torch.ops import sparse as sp
    shapes = level_shapes(cfg.sparse_shape)
    keys = [sp.coords_to_keys(coords, shapes[0])]
    for lvl in (1, 2):
        keys.append(sp.downsample_keys(keys[-1], shapes[lvl - 1],
                                       cfg.caps.level_caps[lvl]))
    return keys


def k17_bound(torch, prev, keys) -> dict:
    """K17's bound: both key arrays read once and one 32-byte sector
    written for each valid key cleared or set."""
    from sassd_tpu_torch.ops import sparse as sp
    n = int((prev != sp.INVALID_KEY).sum()) + int((keys != sp.INVALID_KEY)
                                                  .sum())
    return bound(4 * (prev.numel() + keys.numel()) + 32 * n, 0)


def check_k17(torch, np, device, cfg, root: str) -> dict:
    """Phase 14a: K17 on phase 6's synthetic car scans in sequence, the
    three levels at their full shapes in one update_index_maps call a
    scan, and on the edge cases: the first scan (no previous keys), the
    last scan twice, an empty scan, a scan at each level's cap, then the
    first scan again. After every call each carried map must equal its
    plain version's (run on the card) and K6's fresh map bit for bit.
    Timed on the update from scan 0 to scan 1: the three levels in one
    call, and each level alone (a one-level call), each read four ways
    (events, replay, torch.profiler's kernel time, host clock), beside
    K6's map entry point (memset + scatter) and two index_put_ calls (the
    clear and the set) a level. Returns K17's row."""
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.models.backbone import level_shapes
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.ops.cuda import same_bits
    cfg_pts, ds, _, batch1, _ = serving_split(torch, np, device, cfg, root)
    lattice = serve.serving_lattice(cfg_pts, ds.anchors_bv).to(device)
    scans = []
    for b in batch1:
        pts, n = (torch.from_numpy(b[k]).to(device)
                  for k in ("points", "n_points"))
        scans.append(level_keys(cfg, serve.batch_from_points(
            pts, n, lattice, cfg_pts)["coords"]))
    shapes = level_shapes(cfg.sparse_shape)[:3]
    caps = cfg.caps.level_caps[:3]
    rng = np.random.default_rng(SEED + 14)
    empty, full = [], []
    for shape, cap in zip(shapes, caps):
        total = int(np.prod(shape))
        empty.append(torch.full((1, cap), sp.INVALID_KEY, dtype=torch.int32,
                                device=device))
        full.append(empty[-1].clone())
        n_full = min(cap, total)        # cap on the car grids; all at tiny
        full[-1][0, :n_full] = torch.from_numpy(np.sort(rng.choice(
            total, n_full, replace=False)).astype(np.int32))
    seq = [("scan 0, no previous keys", scans[0])]
    seq += [(f"scan {i}", s) for i, s in enumerate(scans)][1:]
    seq += [(f"scan {N_SCANS - 1} again", scans[-1]), ("an empty scan", empty),
            ("a scan at the cap", full), ("scan 0 after the cap", scans[0])]
    maps = [torch.full((1, int(np.prod(s))), -1, dtype=torch.int32,
                       device=device) for s in shapes]
    plain = [m.clone() for m in maps]
    prev = empty
    counts = []
    for what, keys in seq:
        before = sp._K17.launches
        sp.update_index_maps(maps, prev, keys, shapes)
        if sp._K17.launches != before + maps[0].is_cuda:
            fail(f"K17, {what}: {sp._K17.launches - before} launches for "
                 f"the three levels' update, not 1")
        sp.update_index_maps_plain(plain, prev, keys)
        for lvl in range(3):
            fresh = sp.build_index_map(keys[lvl], shapes[lvl])
            torch.cuda.synchronize()
            if not (same_bits(maps[lvl], plain[lvl])
                    and same_bits(maps[lvl], fresh)):
                fail(f"K17 at level {lvl}, {what}: the carried map differs "
                     f"from its plain version's or K6's fresh map")
        counts.append([int((k != sp.INVALID_KEY).sum()) for k in keys])
        prev = keys
    del fresh, plain
    print(f"K17, the three levels {[tuple(s) for s in shapes]} (caps "
          f"{list(caps)}) in one call a scan: {len(seq)} updates, each one "
          f"launch, bitwise equal to the plain version and to K6's fresh "
          f"maps; valid keys {counts}")
    # timing: the update from scan 0 to scan 1, repeated (each call clears
    # scan 0's cells and sets scan 1's: the same work)
    k0, k1 = scans[0], scans[1]
    for lvl in range(3):
        maps[lvl].copy_(sp.build_index_map(k0[lvl], shapes[lvl]))

    def k17():
        return sp.update_index_maps(maps, k0, k1, shapes)
    t = measured(k17, "K17, the three levels in one call")
    plain_ms = cuda_ms(lambda: sp.update_index_maps_plain(maps, k0, k1),
                       iters=5)
    levels = []
    for lvl, shape in enumerate(shapes):
        imap = maps[lvl]
        one = measured(lambda: sp.update_index_map(imap, k0[lvl], k1[lvl],
                                                   shape),
                       f"K17 level {lvl} alone")
        k6 = measured(lambda: sp.build_index_map(k1[lvl], shape),
                      f"K6 map level {lvl} (memset + scatter)")
        flat = imap.view(-1)
        idx0 = k0[lvl][k0[lvl] != sp.INVALID_KEY].long()
        ok1 = k1[lvl] != sp.INVALID_KEY
        idx1 = k1[lvl][ok1].long()
        rows1 = torch.arange(k1[lvl].shape[1], dtype=torch.int32,
                             device=device)[ok1[0]]
        minus = torch.full_like(rows1[:1], -1)

        def index_put():
            flat.index_put_((idx0,), minus.expand(idx0.shape[0]))
            flat.index_put_((idx1,), rows1)
        lib = measured(index_put, f"two index_put_ calls level {lvl}")
        if not same_bits(imap, sp.build_index_map(k1[lvl], shape)):
            fail(f"K17 level {lvl}: the timed updates left another map")
        levels.append(dict(level=lvl, shape=list(shape),
                           n_prev=counts[0][lvl], n_keys=counts[1][lvl],
                           valid_keys=[c[lvl] for c in counts],
                           alone=one, k6_map_ms=k6["ms"],
                           k6_map_graph_ms=k6["graph_ms"],
                           k6_map_profiler_ms=k6["profiler_ms"],
                           index_put_ms=lib["ms"],
                           index_put_graph_ms=lib["graph_ms"],
                           index_put_profiler_ms=lib["profiler_ms"],
                           **k17_bound(torch, k0[lvl], k1[lvl])))
        del flat
    del maps, imap
    torch.cuda.synchronize()
    for r in levels:
        one = r["alone"]
        print(f"  K17 level {r['level']} alone: kernel {one['ms']:.4f} ms "
              f"({one['graph_ms']:.4f} replayed, profiler "
              f"{one['profiler_ms'] or 0:.4f}); K6 map {r['k6_map_ms']:.4f} "
              f"(profiler {r['k6_map_profiler_ms'] or 0:.4f}); two "
              f"index_put_ {r['index_put_ms']:.4f} (profiler "
              f"{r['index_put_profiler_ms'] or 0:.4f}); bound "
              f"{r['bound_ms']:.5f} ms")
    bd = add_bounds(levels)
    print(f"  K17, the three levels in one call: kernel {t['ms']:.4f} ms "
          f"({t['graph_ms']:.4f} replayed, profiler "
          + ("not measured" if t["profiler_ms"] is None
             else f"{t['profiler_ms']:.4f}")
          + f", host {t['host_us']:.1f} us), plain {plain_ms:.4f} ms; bound "
          f"{bd['bound_ms']:.5f} ms")
    return dict(name="K17 update_index_maps", route="cuda",
                source="sassd_tpu_torch/csrc/device_plans.cu",
                replaces="sassd_tpu/serve.py:262",
                max_abs_err=0.0, **t, plain_ms=plain_ms,
                library_ms=None,
                library_what="none: no one call clears one key set and "
                             "scatters another; two index_put_ calls (clear, "
                             "set) a level timed beside it as index_put_ms",
                index_put_ms=sum(r["index_put_ms"] for r in levels),
                index_put_profiler_ms=sum(r["index_put_profiler_ms"] or 0.0
                                          for r in levels),
                k6_map_ms=sum(r["k6_map_ms"] for r in levels),
                at="the three levels' update from phase 6's scan 0 to scan "
                   "1 in one call, batch 1", levels=levels, **bd)


def run_persistent_serving(torch, np, device, cfg, model_dev,
                           root: str) -> dict:
    """Phase 14b: run_inference at batch 1 with
    test.serve_persistent_plans over phase 6's 4-scan split, launch
    counters reset just before and read just after: K17 once a scan (the
    three levels), K6's map entry point never, K6's plans once a scan. Its
    plans must be bitwise those of the per-scan run (captured from
    sp.device_rulebook and serve.plans_from_carry), its annotations
    bitwise or at least the same sets. Then both steps are timed in turns
    on the host clock (upload inside, synchronised), and the rulebook
    stage by torch.profiler."""
    import dataclasses
    from sassd_tpu_torch import inference, serve
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.ops.cuda import same_bits
    cfg_pts, ds, step, batch1, _ = serving_split(torch, np, device, cfg,
                                                 root)
    cfg_p = dataclasses.replace(cfg_pts, test=dataclasses.replace(
        cfg_pts.test, serve_persistent_plans=True))
    step_p = serve.make_serving_step(cfg_p, ds.anchors, ds.anchors_bv,
                                     device, persistent_plans=True)
    warm = serve.init_plan_carry(cfg_p, device)
    step(model_dev, batch1[0])
    step_p(model_dev, warm, batch1[0])
    del warm
    torch.cuda.synchronize()
    got_plans, ref_plans = [], []
    orig_rb, orig_pc = sp.device_rulebook, serve.plans_from_carry

    def rulebook(*args, **kw):
        out = orig_rb(*args, **kw)
        ref_plans.append({k: v.clone() for k, v in out.items()})
        return out

    def from_carry(*args):
        plans, carry = orig_pc(*args)
        got_plans.append({k: v.clone() for k, v in plans.items()})
        return plans, carry
    sp.device_rulebook = rulebook
    try:
        ref = inference.run_inference(cfg_pts, ds, model_dev, 1, device)
    finally:
        sp.device_rulebook = orig_rb
    torch.cuda.synchronize()
    serve.plans_from_carry = from_carry
    try:
        reset_launches()
        got = inference.run_inference(cfg_p, ds, model_dev, 1, device)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        serve.plans_from_carry = orig_pc
    n = len(got[1])
    want = {"sassd_index_maps_update": n, "sassd_index_map": 0,
            "sassd_window_plans": n}
    seen = {k: launches[k] for k in want}
    print(f"persistent serving: {n} scans; launches {seen} (want {want}); "
          f"all {launches}")
    if seen != want:
        fail(f"persistent serving launched {seen}, not {want}")
    check_launched(launches, "K1 K2 K3 K4 K5 K7 K8 K9 K17",
                   "persistent serving")
    if len(got_plans) != n or len(ref_plans) != n:
        fail(f"persistent serving: {len(got_plans)} and {len(ref_plans)} "
             f"rulebooks captured for {n} scans")
    for i, (g, r) in enumerate(zip(got_plans, ref_plans)):
        if sorted(g) != sorted(r) or not all(same_bits(g[k], r[k])
                                             for k in g):
            fail(f"persistent serving, scan {i}: its plans differ from the "
                 f"per-scan rulebook's")
    bitwise = all(a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a) for a, b in zip(got[0], ref[0]))
    counts = [match_annos(np, a, b, f"persistent serving, scan {i}")
              for i, (a, b) in enumerate(zip(got[0], ref[0]))]
    print(f"persistent serving: plans bitwise the per-scan rulebook's on all "
          f"{n} scans; annotations {'bitwise equal' if bitwise else 'the same sets'}"
          f" ({counts} detections)")

    reset_launches()
    carry = serve.init_plan_carry(cfg_p, device)
    step_p(model_dev, carry, batch1[0])
    torch.cuda.synchronize()
    per_step = read_launches()
    check_counts(per_step, RULEBOOK_CALLS["persistent"],
                 "persistent serving, one step")

    ms, rulebook_ms = serving_modes_timed(torch, model_dev, step, step_p,
                                          carry, batch1)
    return dict(launches=launches, per_step=per_step, ms=ms,
                rulebook_ms=rulebook_ms, bitwise=bitwise)


def serving_modes_timed(torch, model_dev, step, step_p, carry, batch1):
    """The per-scan and the persistent serving step over the scans of
    batch1: on the host clock in turns (per-scan, persistent, persistent,
    per-scan; synchronised, upload inside), then the rulebook stage of
    each by torch.profiler (its kernels and its span, ms/scan)."""
    from torch.profiler import ProfilerActivity, profile
    from sassd_tpu_torch.profile_slice import stage_times

    def per_scan(b):
        step(model_dev, b)

    def persistent(b):
        nonlocal carry
        _, carry = step_p(model_dev, carry, b)
    modes = {"per-scan": per_scan, "persistent": persistent}
    ms = {k: [] for k in modes}
    for mode in ("per-scan", "persistent", "persistent", "per-scan"):
        for b in batch1:
            t = time.perf_counter()
            modes[mode](b)
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t) * 1e3)
    rulebook_ms = {}
    for mode, fn in modes.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for b in batch1:
                fn(b)
            torch.cuda.synchronize()
        rulebook_ms[mode] = stage_times(prof, len(batch1)).get("rulebook")
    for mode in modes:
        kern, span = rulebook_ms[mode] or (None, None)
        print(f"persistent serving: {mode} step "
              f"{', '.join(f'{m:.2f}' for m in ms[mode])} ms/scan (host "
              f"clock, synchronised, upload inside; in turns); rulebook "
              f"stage by the profiler: kernels "
              f"{'not measured' if kern is None else f'{kern:.4f}'}, span "
              f"{'not measured' if span is None else f'{span:.4f}'} "
              f"ms/scan")
    return ms, rulebook_ms


def train_split_batch(np, cfg, root: str):
    """Phase 7's batch: the first two scans of its 4-scan train split
    (written under root, phase 7's seed), and the anchors."""
    import torch
    from sassd_tpu_torch.data import kitti, synthetic
    synthetic.write_synthetic_kitti(root, n_train=N_SCANS, n_val=0,
                                    seed=SEED + 3)
    ds = kitti.KittiDataset(cfg, os.path.join(root, "training"),
                            os.path.join(root, "ImageSets", "train.txt"),
                            train=True)
    return kitti.collate([ds[0], ds[1]])[0], torch.from_numpy(ds.anchors)


def similarity_steps(torch, cfg, batch, anchors, runs,
                     backward: bool = True) -> dict:
    """forward_train (and, with `backward`, its backward) of cfg's seeded
    car model on `batch` for each (name, device, dtype) of `runs`. Returns
    res[name] = (losses, seconds, gradients by parameter name or None,
    (positives, negatives) of each RPN target assignment, K1's launches
    inside each call of the RPN similarity)."""
    from sassd_tpu_torch import weights
    from sassd_tpu_torch.core import targets as target_ops
    from sassd_tpu_torch.inference import to_device
    from sassd_tpu_torch.models.detector import parse_losses
    from sassd_tpu_torch.ops import cuda
    name = cfg.train.rpn_similarity
    sim, orig_ct = target_ops.SIMILARITY_FNS[name], target_ops.create_targets
    k1 = cuda.KERNELS["sassd_riou_overlap"]
    res = {}
    for run, where, dtype in runs:
        k1_in, assign = [], []

        def counted(a, g):
            before = k1.launches
            out = sim(a, g)
            k1_in.append(k1.launches - before)
            return out

        def create_targets(a, g, gv, fn, *args, **kw):
            out = orig_ct(a, g, gv, fn, *args, **kw)
            if fn is counted:
                assign.append((int((out.labels > 0).sum()),
                               int((out.labels == 0).sum())))
            return out
        model = weights.seeded_detector(cfg, SEED, where).to(dtype)
        model.train()
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in to_device(batch, where).items()}
        t = time.perf_counter()
        target_ops.SIMILARITY_FNS[name] = counted
        target_ops.create_targets = create_targets
        try:
            losses = model.forward_train(b, anchors.to(where, dtype))
        finally:
            target_ops.SIMILARITY_FNS[name] = sim
            target_ops.create_targets = orig_ct
        grads = None
        if backward:
            parse_losses(losses).backward()
            grads = {k: p.grad.detach().cpu().double()
                     for k, p in model.named_parameters()}
        if where != "cpu":
            torch.cuda.synchronize()
        res[run] = ({k: float(v.detach()) for k, v in losses.items()},
                    time.perf_counter() - t, grads, assign, k1_in)
    return res


def run_similarity_training(torch, np, device, cfg, batch, anchors) -> dict:
    """Phase 14c: one car batch-2 forward_train + backward with
    train.rpn_similarity="RotateIou2dSimilarity" on the card, the CPU and
    the CPU in float64, at phase 7's gates (step_gates), with equal RPN
    positive and negative counts and K1 launched once in each call of the
    similarity (a sample and class slice), launch counters reset just
    before the card step and read just after; then a DistanceSimilarity
    forward_train on the card and the CPU: equal assignment counts,
    finite losses. K1 at the targets shape (the anchors x sample 0's 64
    GT slots, criterion -1) is held to its plain version and timed.
    Returns its row and the card step's launches."""
    import dataclasses
    from sassd_tpu_torch.core import riou
    from sassd_tpu_torch.ops import riou_kernel
    out = {}
    for sim in ("RotateIou2dSimilarity", "DistanceSimilarity"):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, rpn_similarity=sim))
        rotated = sim == "RotateIou2dSimilarity"
        runs = [("cpu", "cpu", torch.float32)]
        if rotated:
            runs.insert(0, ("cpu64", "cpu", torch.float64))
        res = similarity_steps(torch, c, batch, anchors, runs,
                               backward=rotated)
        reset_launches()
        res.update(similarity_steps(torch, c, batch, anchors,
                                    [("card", device, torch.float32)],
                                    backward=rotated))
        out[sim] = read_launches()
        what = f"{sim} training"
        assign = {k: v[3] for k, v in res.items()}
        print(f"{what}: RPN (positives, negatives) a sample and class "
              f"slice: {assign}; K1 launches inside each similarity call "
              f"on the card: {res['card'][4]}")
        if len({tuple(v) for v in assign.values()}) != 1:
            fail(f"{what}: the card's RPN assignment counts differ from the "
                 f"CPU's")
        if not all(np.isfinite(list(v[0].values())).all()
                   for v in res.values()):
            fail(f"{what}: a loss is not finite")
        n_slices = batch["gt_boxes"].shape[0] * cfg.model.num_class
        if rotated:
            if res["card"][4] != [1] * n_slices:
                fail(f"{what}: K1 launched {res['card'][4]} times in the "
                     f"similarity calls, not once in each of {n_slices}")
            step_gates(torch, res, what)
        else:
            cl, gl = res["cpu"][0], res["card"][0]
            print(f"{what}: losses card {gl}, CPU {cl}")
    check_launched(out["RotateIou2dSimilarity"],
                   "K1 K3 K3b K4 K5 K5b K10 K11 K12", "RotateIou2d training")

    # K1 at the targets shape
    a5 = riou.boxes3d_to_bev5(anchors[:anchors.shape[0]
                                      // cfg.model.num_class]).to(device)
    g5 = riou.boxes3d_to_bev5(torch.from_numpy(batch["gt_boxes"][0])).to(
        device)
    got = riou_kernel.rotate_overlap(a5, g5, -1)
    ref = riou_kernel.rotate_overlap_plain(a5, g5, -1)
    near = riou_kernel.near_pairs_plain(a5, g5)
    err = float((got - ref).abs().max())
    culled = int((got.view(torch.int32)[~near] != 0).sum())
    n, m, n_near = a5.shape[0], g5.shape[0], int(near.sum())
    print(f"K1 at the targets shape {n} x {m}, criterion -1: "
          f"max|kernel-plain| {err:.3g} (tol {K1_ATOL}); near pairs "
          f"{n_near} ({n_near / n / m:.4%}); culled pairs not +0.0: "
          f"{culled}")
    if not err <= K1_ATOL or culled:
        fail("K1 disagrees with its plain version at the targets shape")
    t = measured(lambda: riou_kernel.rotate_overlap(a5, g5, -1),
                 f"K1 at the targets shape {n} x {m}")
    plain_ms = cuda_ms(lambda: riou_kernel.rotate_overlap_plain(a5, g5, -1),
                       iters=5)
    print(f"  K1 targets shape: plain {plain_ms:.4f} ms; bound "
          f"{k1_bound(n, m, n_near)['bound_ms']:.5f} ms")
    row = dict(name="K1 rotate_overlap, targets shape", route="cuda",
               source="sassd_tpu_torch/csrc/riou_overlap.cu",
               replaces="sassd_tpu/core/targets.py:43",
               max_abs_err=err, **t, plain_ms=plain_ms, library_ms=None,
               library_what="none: torch has no rotated-box overlap",
               at=f"{n} anchors x {m} GT slots (sample 0 of phase 7's "
                  f"batch), criterion -1",
               n_near=n_near, **k1_bound(n, m, n_near))
    return dict(row=row, launches=out["RotateIou2dSimilarity"],
                distance_launches=out["DistanceSimilarity"])


def run_phase14(torch, np, device, cfg, model_dev, train_ref=None) -> dict:
    """Phase 14: persistent-plan serving (14a K17, 14b run_inference) and
    the two RPN similarities (14c), on phase 7's batch when `train_ref` is
    given, else on a train split written here. Returns the kernel rows,
    14b's results and 14c's launches."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        k17 = check_k17(torch, np, device, cfg, root)
    t_a = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        persistent = run_persistent_serving(torch, np, device, cfg,
                                            model_dev, root)
    t_b = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        if train_ref is None:
            batch, anchors = train_split_batch(np, cfg, root)
        else:
            batch, anchors = train_ref["batch"], train_ref["anchors"]
        sim = run_similarity_training(torch, np, device, cfg, batch,
                                      anchors)
    wall = time.perf_counter() - t
    print(f"persistent serving and similarities: phase 14 took {wall:.1f} s "
          f"(14a {t_a - t:.1f}, 14b {t_b - t_a:.1f}, 14c "
          f"{t + wall - t_b:.1f}; 14c's CPU steps are most of it)")
    return dict(rows=[k17, sim["row"]], persistent=persistent,
                similarity=sim, wall_s=wall)


# ------------------------------------------------------------ phase 15

# an estimate, printed beside K18-K20's bounds and kept out of their
# rows: one dependent load that hits the H100's L2, ~260 cycles at 1.98
# GHz in published microbenchmarks (not measured here)
L2_HIT_US = 0.13


def sorted_cfg(cfg):
    """cfg with model.plan_lookup="sorted"."""
    import dataclasses
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, plan_lookup="sorted"))


def sorted_levels(sp, keys0, shapes, caps, y_top=None) -> list:
    """The keys of levels 0-3 as device_rulebook makes them (K7; level
    L's downsample clipped at y_top >> L where the limits are given)."""
    keys = [keys0]
    for lvl in (1, 2, 3):
        keys.append(sp.downsample_keys(
            keys[-1], shapes[lvl - 1], caps[lvl - 1],
            None if y_top is None else y_top >> lvl))
    return keys


def sorted_check(torch, sp, what: str, keys, shapes) -> dict:
    """15a: K18 (a scan's six plans), K19 and K20, each one call on the
    keys of levels 0-3, against their plain versions on the same card
    tensors and against K6's plans, K13 and K14 through the levels' index
    maps, bitwise. Returns the entries differing, the largest absolute
    difference from the plain version (err), the found fractions and the
    levels' valid keys; fails on any difference."""
    maps = [sp.build_index_map(k, s) for k, s in zip(keys, shapes)]
    cell0 = sp.keys_to_coords(keys[0], shapes[0])
    specs = sp.rulebook_specs(keys, shapes, keys[:3])
    runs = {
        "K18": (sp.sorted_window_plans(specs),
                sp.sorted_window_plans_plain(specs),
                sp.window_plans(sp.rulebook_specs(keys, shapes, maps[:3]))),
        "K19": (sp.sorted_stride_plans_T(keys[:3], keys[1:], shapes),
                sp.sorted_stride_plans_T_plain(keys[:3], keys[1:], shapes),
                sp.stride_plans_T(keys[:3], maps[1:], shapes)),
        "K20": (sp.sorted_aux_plans(cell0, keys[1:], shapes[1:]),
                sp.sorted_aux_plans_plain(cell0, keys[1:], shapes[1:]),
                sp.aux_plans(cell0, maps[1:], shapes[1:]))}
    del maps
    torch.cuda.synchronize()
    diff, found, err = {}, {}, {}
    for kid, (got, plain, dense) in runs.items():
        diff[kid] = (sum(int((g != p).sum()) for g, p in zip(got, plain)),
                     sum(int((g != d).sum()) for g, d in zip(got, dense)))
        err[kid] = max(float((g.long() - p.long()).abs().max())
                       for g, p in zip(got, plain))
        found[kid] = round(sum(int((g >= 0).sum()) for g in got)
                           / sum(g.numel() for g in got), 4)
    n = [int((k != sp.INVALID_KEY).sum()) for k in keys]
    print(f"15a, {what}: valid keys by level {n}; entries differing (from "
          f"plain, from K6/K13/K14 through the maps): {diff}; found "
          f"fractions {found}")
    if any(a or b for a, b in diff.values()):
        fail(f"15a, {what}: K18-K20 differ from their plain versions or "
             f"from the dense-map plans")
    return dict(diff=diff, err=err, found=found, valid_keys=n)


def distinct_bytes(tensors) -> int:
    """The bytes of the distinct tensors among `tensors` (a key array
    that several plans search is read once)."""
    seen = {t.data_ptr(): t.numel() * t.element_size() for t in tensors}
    return sum(seen.values())


# 15a's search edge cases on the grid EDGE_GRID: (the keys a level holds
# m_in, valid level-0 keys by sample). m_in = 1; 7, 8 (a sample all
# padding) and 9 keys; 30 (not a multiple of 4); 2051 with the valid keys
# ending on and one past a multiple of 1024; every cell of the grid
# (3840), once beside an empty sample
EDGE_GRID = (8, 24, 20)
SEARCH_EDGES = ((1, (1, 0)), (7, (7, 5)), (8, (8, 0)), (9, (9, 8)),
                (30, (30, 17)), (2051, (2048, 1025)),
                (3840, (3840, 3839, 0)), (3840, (3840, 2000)),
                (2051, (2048, 1500)))


def search_edges(torch, np, sp, device) -> list:
    """15a's search edge cases (SEARCH_EDGES): each case's keys of levels
    0-3 (K7 downsampling at the case's m_in as every level's cap) through
    sorted_check. Returns the checks."""
    d, h, w = EDGE_GRID
    shapes = [EDGE_GRID]
    for _ in range(3):
        shapes.append(sp.out_shape_stride2(shapes[-1]))
    rng = np.random.default_rng(SEED + 25)
    checks = []
    for m, valid in SEARCH_EDGES:
        keys0 = np.full((len(valid), m), sp.INVALID_KEY, np.int32)
        for i, n in enumerate(valid):
            keys0[i, :n] = np.sort(rng.choice(d * h * w, n, replace=False))
        keys = sorted_levels(sp, torch.from_numpy(keys0).to(device), shapes,
                             (m, m, m))
        c = sorted_check(torch, sp, f"edge case: m_in {m}, valid keys "
                         f"{valid}", keys, shapes)
        checks.append(dict(c, m_in=m))
    return checks


def sorted_calls(torch, sp, kid: str, keys, shapes) -> dict:
    """K18's, K19's or K20's call on the keys of levels 0-3 (a scan's six
    plans, the transpose plans or the aux plans, the three levels in one
    call), its plain version, its map-reading twin (K6's six plans, K13 or
    K14, through maps built here, outside any timing), the bytes of its
    bound (plans written, cell0 and the distinct key arrays read once),
    the m_in of its deepest search, and its yardstick's window starts
    ((keys, starts) int32 pairs, a torch.searchsorted call each)."""
    maps = {lvl: sp.build_index_map(keys[lvl], shapes[lvl])
            for lvl in ((0, 1, 2) if kid == "K18" else (1, 2, 3))}
    if kid == "K18":
        specs = sp.rulebook_specs(keys, shapes, keys[:3])
        dspecs = sp.rulebook_specs(keys, shapes, [maps[0], maps[1], maps[2]])
        fn = lambda: sp.sorted_window_plans(specs)  # noqa: E731
        plain = lambda: sp.sorted_window_plans_plain(specs)  # noqa: E731
        dense = lambda: sp.window_plans(dspecs)  # noqa: E731
        starts = []
        for lvl in range(3):
            st = [sp.window_starts(sp.keys_to_coords(k, shp).long() * scale,
                                   shapes[lvl])[0].flatten(1)
                  for k, shp, scale in ((keys[lvl], shapes[lvl], 1),
                                        (keys[lvl + 1], shapes[lvl + 1], 2))]
            starts.append((keys[lvl], torch.cat(st, 1).to(torch.int32)))
        read = [t for spec in specs for t in (spec[0], spec[2])]
        m_in = keys[0].shape[1]
    elif kid == "K19":
        fn = lambda: sp.sorted_stride_plans_T(  # noqa: E731
            keys[:3], keys[1:], shapes)
        plain = lambda: sp.sorted_stride_plans_T_plain(  # noqa: E731
            keys[:3], keys[1:], shapes)
        dense = lambda: sp.stride_plans_T(  # noqa: E731
            keys[:3], [maps[1], maps[2], maps[3]], shapes)
        starts = [(keys[lvl], sp.stride_T_starts(
            keys[lvl - 1], shapes[lvl - 1], shapes[lvl])[0].flatten(1).to(
                torch.int32)) for lvl in (1, 2, 3)]
        read = list(keys)
        m_in = keys[1].shape[1]
    else:
        cell0 = sp.keys_to_coords(keys[0], shapes[0])
        fn = lambda: sp.sorted_aux_plans(  # noqa: E731
            cell0, keys[1:], shapes[1:])
        plain = lambda: sp.sorted_aux_plans_plain(  # noqa: E731
            cell0, keys[1:], shapes[1:])
        dense = lambda: sp.aux_plans(  # noqa: E731
            cell0, [maps[1], maps[2], maps[3]], shapes[1:])
        starts = [(keys[lvl], sp.window_starts(
            cell0.long() >> lvl, shapes[lvl])[0].flatten(1).to(torch.int32))
            for lvl in (1, 2, 3)]
        read = [cell0] + list(keys[1:])
        m_in = keys[1].shape[1]
    out = fn()
    out = out if isinstance(out, (list, tuple)) else [out]
    nbytes = sum(p.numel() * 4 for p in out) + distinct_bytes(read)
    return dict(fn=fn, plain=plain, dense=dense, starts=starts,
                nbytes=nbytes, m_in=m_in)


# the map-reading twin of each sorted kernel, timed beside it
SORTED_TWINS = {"K18": "K6's six plans", "K19": "K13", "K20": "K14"}
# K18's, K19's and K20's block, threads (kSortedThreads, kStrideTThreads
# in csrc/device_plans.cu)
SORTED_BLOCK = 128


def sorted_at(torch, sp, kid: str, keys, shapes, what: str,
              calls: bool = False) -> dict:
    """K18's, K19's or K20's call at one shape (sorted_calls), read four
    ways (measured), beside its map-reading twin read the same way and
    its bound (bytes), with its block (SORTED_BLOCK threads) and the
    kernel the profiler saw, which names its launch form (K18 and K20:
    sorted_plans_kernel<., 9>, a thread a row, or <., 3>, a thread a
    row's z plane of taps; K19: sorted_stride_plans_t_kernel, a thread a
    row at every shape). The
    dependent-load chain of a full binary search over m_in keys is
    printed beside the bound as an estimate (L2_HIT_US a load), not as
    the bound, and kept out of the row. `calls` keeps sorted_calls' result
    (and its maps) under "calls", for sorted_row."""
    c = sorted_calls(torch, sp, kid, keys, shapes)
    t = measured(c["fn"], f"{kid}, {what}", iters=100)
    twin = measured(c["dense"], f"{SORTED_TWINS[kid]} through the maps, "
                                f"{what}", iters=100)
    bd = bound(c["nbytes"], 0)
    depth = (max(c["m_in"], 2) - 1).bit_length() + 3
    out = dict(at=what, **t, **bd, dense=twin, block=SORTED_BLOCK)
    print(f"  {kid}, {what}: bound {bd['bound_ms']:.4f} ms (bytes: plans "
          f"written, keys read once); block {SORTED_BLOCK} threads, kernel "
          f"{', '.join(t['kernel_split']) or 'not seen'}; profiler "
          + ("not measured" if t["profiler_ms"] is None
             else f"{t['profiler_ms']:.4f}")
          + f" ms, {SORTED_TWINS[kid]} "
          + ("not measured" if twin["profiler_ms"] is None
             else f"{twin['profiler_ms']:.4f}")
          + f" ms; a full binary search's dependent-load chain {depth} "
          f"loads, ~{depth * L2_HIT_US:.2f} us a thread at ~{L2_HIT_US} us "
          f"an L2 hit (an estimate, not the bound)")
    return dict(out, calls=c) if calls else out


def sorted_row(torch, kid: str, name: str, at: dict, replaces: str,
               shapes: dict) -> dict:
    """K18-K20's row: its reading at its main shape (sorted_at), its plain
    version, and its yardstick, torch.searchsorted of the same window
    starts over the same keys, one call an input level, every start
    searched where the kernel skips the groups off the grid: the search
    alone, a component (the window compare and the plans' write are not
    timed), as B6's torch.sort. `shapes` holds its readings at the other
    shapes. The row's max_abs_err is set by run_phase15 from 15a's checks
    of the same kernel."""
    c = at.pop("calls")
    plain_ms = cuda_ms(c["plain"], iters=5)
    lib = measured(lambda: [torch.searchsorted(k, s) for k, s in c["starts"]],
                   f"{kid}'s yardstick (torch.searchsorted of the same "
                   f"starts), {at['at']}", iters=100)
    print(f"  {kid} {name}, {at['at']}: plain {plain_ms:.4f} ms; yardstick "
          f"{lib['ms']:.4f} ms")
    return dict(name=f"{kid} {name}", route="cuda",
                source="sassd_tpu_torch/csrc/device_plans.cu",
                replaces=replaces, **at, plain_ms=plain_ms,
                library_ms=lib["ms"], library_graph_ms=lib["graph_ms"],
                library_profiler_ms=lib["profiler_ms"],
                library_host_us=lib["host_us"],
                library_what="torch.searchsorted of the kernel's window "
                             "starts over the same keys, one call an "
                             "input level: the search alone, a component "
                             "(no window compare, no plan written)",
                shapes=shapes)


# the sorted rulebook's C calls on a path: K7 for levels 1-3 and one K18
# call; in training one K19 call and, with the ring aux, one K20 call; no
# map and none of K6's, K13's or K14's entry points
SORTED_CALLS = {
    "inference": {"sassd_downsample": 3, "sassd_sorted_window_plans": 1,
                  "sassd_sorted_stride_plans_t": 0,
                  "sassd_sorted_aux_plans": 0, "sassd_index_map": 0,
                  "sassd_window_plans": 0},
    "training": {"sassd_downsample": 3, "sassd_sorted_window_plans": 1,
                 "sassd_sorted_stride_plans_t": 1,
                 "sassd_sorted_aux_plans": 1, "sassd_index_map": 0,
                 "sassd_window_plans": 0, "sassd_stride_plans_t": 0,
                 "sassd_aux_plans": 0}}


def rulebook_turns(sp, what: str, keys0, shapes, caps, **kw) -> dict:
    """The rulebook stage's kernels (device_rulebook(keys0, shapes, caps,
    **kw)) by torch.profiler, ms a call, plan_lookup dense and sorted in
    turns (dense, sorted, sorted, dense), each printed with its kernels."""
    out = {"dense": [], "sorted": []}
    for mode in ("dense", "sorted", "sorted", "dense"):
        split = kernel_split(lambda: sp.device_rulebook(
            keys0, shapes, caps, plan_lookup=mode, **kw))
        out[mode].append(dict(ms=sum(split.values()) if split else None,
                              split=split))
    print(f"{what}: the rulebook stage's kernels (torch.profiler ms a call, "
          f"in turns): " + "; ".join(
              f"{mode} " + ", ".join("not measured" if r["ms"] is None
                                     else f"{r['ms']:.4f}" for r in v)
              for mode, v in out.items()))
    for mode, v in out.items():
        print(f"  {mode} rulebook kernels: {v[0]['split']}")
    return out


def peak_owners(torch, fn, what: str, top: int = 8) -> dict:
    """The device memory live at fn()'s peak, by the innermost frame of
    the port's code that allocated it: torch.cuda.memory's allocation
    history over the call (Python stacks), replayed to the event at which
    the allocated bytes were highest. Memory allocated before the call
    (start_mib) has no frame in it. Prints the `top` owners; returns them
    with the start and the peak (MiB)."""
    mem = torch.cuda.memory
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    mem._record_memory_history(max_entries=2_000_000, stacks="python")
    try:
        fn()
        torch.cuda.synchronize()
        trace = mem._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        mem._record_memory_history(enabled=None)
    live, cur, best, at = {}, 0, 0, -1
    for i, e in enumerate(trace):           # first pass: where the peak is
        if e["action"] == "alloc":
            live[e["addr"]] = e["size"]
            cur += e["size"]
            if cur > best:
                best, at = cur, i
        elif e["action"] in ("free_requested", "free_completed"):
            cur -= live.pop(e["addr"], 0)
    live = {}
    for e in trace[:at + 1]:                # second: what is live there
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] in ("free_requested", "free_completed"):
            live.pop(e["addr"], None)
    owners = {}
    for e in live.values():
        frame = next((f for f in e.get("frames", ())
                      if "sassd_tpu_torch" in f["filename"]), None)
        name = ("no frame of the port" if frame is None else
                f"{frame['filename'].split('sassd_tpu_torch/')[-1]}:"
                f"{frame['line']} {frame['name']}")
        owners[name] = owners.get(name, 0) + e["size"] / 2**20
    ranked = sorted(owners.items(), key=lambda kv: -kv[1])[:top]
    print(f"{what}: live at its peak, by the port's allocating frame "
          f"(MiB, {len(trace)} events): allocated at the start "
          f"{start / 2**20:.1f}, over it at the peak {best / 2**20:.1f}; "
          + "; ".join(f"{k} {v:.1f}" for k, v in ranked))
    return dict(start_mib=start / 2**20, over_start_mib=best / 2**20,
                owners=dict(ranked), events=len(trace))


def sorted_serving(torch, np, device, cfg_pts, ds, step, batch1, model_dev,
                   keys0) -> dict:
    """15b: run_inference over phase 6's 4-scan split at batch 1 and 2,
    model.plan_lookup "dense" then "sorted" (the same weights), each
    under peak_mib with the launch counts reset just before and read just
    after: the same detection sets at phase 6's gates; one sorted step's
    rulebook calls; the rulebook stage's kernels of scan 0 at batch 1 by
    torch.profiler, dense and sorted in turns."""
    from sassd_tpu_torch import inference, serve
    from sassd_tpu_torch.models.backbone import level_shapes
    from sassd_tpu_torch.models.detector import Detector
    from sassd_tpu_torch.ops import sparse as sp
    cfg_s = sorted_cfg(cfg_pts)
    model_s = Detector(cfg_s).to(device)
    model_s.load_state_dict(model_dev.state_dict())
    step_s = serve.make_serving_step(cfg_s, ds.anchors, ds.anchors_bv,
                                     device)
    step(model_dev, batch1[0])                          # warm-up
    step_s(model_s, batch1[0])
    torch.cuda.synchronize()
    runs, peaks, launches = {}, {}, {}
    for mode, c, m in (("dense", cfg_pts, model_dev),
                       ("sorted", cfg_s, model_s)):
        reset_launches()
        runs[mode], peaks[mode] = peak_mib(torch, lambda: {
            bs: inference.run_inference(c, ds, m, bs, device)
            for bs in (1, 2)})
        launches[mode] = read_launches()
    n = len(runs["dense"][1][1])
    bitwise, counts = True, []
    for bs in (1, 2):
        for i, (a, b) in enumerate(zip(runs["sorted"][bs][0],
                                       runs["dense"][bs][0])):
            counts.append(match_annos(np, a, b, f"15b, batch {bs}, scan {i}:"
                                      f" sorted vs dense"))
            bitwise &= a.keys() == b.keys() and all(
                np.array_equal(a[k], b[k]) for k in a)
    steps = n + -(-n // 2)
    want = {"sassd_sorted_window_plans": steps, "sassd_index_map": 0,
            "sassd_window_plans": 0}
    seen = {k: launches["sorted"][k] for k in want}
    print(f"15b, sorted serving over {n} scans at batch 1 and 2: rulebook "
          f"launches {seen} (want {want}); all {launches['sorted']}")
    if seen != want or any(launches["dense"][k] for k in (
            "sassd_sorted_window_plans", "sassd_sorted_stride_plans_t",
            "sassd_sorted_aux_plans")):
        fail(f"15b: the sorted serving run launched {seen}, not {want}, or "
             f"the dense one a sorted kernel")
    check_launched(launches["sorted"], "K1 K2 K3 K4 K5 K7 K8 K9 K18",
                   "15b, sorted serving")
    print(f"15b: sorted detections match dense ones at phase 6's gates "
          f"({counts} detections, "
          f"{'bitwise equal' if bitwise else 'the same sets'}); peak device "
          f"memory dense {peaks['dense']['peak_mib']:.1f} MiB, sorted "
          f"{peaks['sorted']['peak_mib']:.1f} MiB (allocated at the start "
          f"{peaks['dense']['start_mib']:.1f} / "
          f"{peaks['sorted']['start_mib']:.1f})")
    reset_launches()
    step_s(model_s, batch1[0])
    torch.cuda.synchronize()
    per_step = read_launches()
    check_counts(per_step, SORTED_CALLS["inference"],
                 "15b, sorted serving, one step")
    shapes = level_shapes(cfg_pts.sparse_shape)
    caps = cfg_pts.caps.level_caps[1:]
    rulebook = rulebook_turns(sp, "15b: scan 0 at batch 1", keys0, shapes,
                              caps)
    owners = {mode: peak_owners(torch, lambda: inference.run_inference(
        c, ds, m, 2, device), f"15b, {mode} run_inference at batch 2")
        for mode, c, m in (("dense", cfg_pts, model_dev),
                           ("sorted", cfg_s, model_s))}
    return dict(launches=launches["sorted"], per_step=per_step, peaks=peaks,
                bitwise=bitwise, rulebook=rulebook, peak_owners=owners)


def sorted_train_steps(torch, device, cfg, batch, anchors, what: str,
                       ids: str) -> dict:
    """15c and 15d: one forward_train + backward of cfg's seeded weights
    (lr_train_step: the gradients of two objectives, so two backward
    passes) on device plans, model.plan_lookup "dense" then "sorted", each
    under peak_mib with the launch counts reset just before and read just
    after; the sorted step held to the dense one at the device-vs-host-
    plans gates (every loss within PLANS_LOSS_RTOL, the other outputs
    equal, the gradients' norm within PLANS_GNORM_RTOL, each module's and
    the BatchNorm updates within PLANS_GRAD_L2)."""
    from sassd_tpu_torch.weights import seeded_detector
    state = seeded_detector(cfg, SEED, device).state_dict()
    res, peaks, launches = {}, {}, {}
    for mode, c in (("dense", cfg), ("sorted", sorted_cfg(cfg))):
        torch.cuda.synchronize()
        reset_launches()
        res[mode], peaks[mode] = peak_mib(torch, lambda: lr_train_step(
            torch, device, c, state, batch, anchors))
        launches[mode] = read_launches()
    check_counts(launches["sorted"], SORTED_CALLS["training"],
                 f"{what}, sorted step")
    check_launched(launches["sorted"], ids, f"{what}, sorted step")
    la, lb = res["dense"]["losses"], res["sorted"]["losses"]
    loss_err = max(abs(lb[k] - v) / max(abs(v), 1e-12)
                   for k, v in la.items() if "loss" in k)
    other = {k: (v, lb[k]) for k, v in la.items()
             if "loss" not in k and lb[k] != v}
    norm, mods = grad_diff(res, "dense", "sorted", "full")
    bn = bn_update_err(res, "dense", "sorted")
    print(f"{what}, sorted vs dense: largest loss rel diff {loss_err:.3g} "
          f"(tol {PLANS_LOSS_RTOL}); other outputs differing {other or 'none'};"
          f" grad norm rel diff {norm:.3g} (tol {PLANS_GNORM_RTOL}); module "
          f"rel L2 { {k: float(f'{v:.3g}') for k, v in mods.items()} } (tol "
          f"{PLANS_GRAD_L2}); BN update diff {bn:.3g}; peak device memory "
          f"dense {peaks['dense']['peak_mib']:.1f} MiB, sorted "
          f"{peaks['sorted']['peak_mib']:.1f} MiB (allocated at the start "
          f"{peaks['dense']['start_mib']:.1f} / "
          f"{peaks['sorted']['start_mib']:.1f})")
    if (other or loss_err > PLANS_LOSS_RTOL or norm > PLANS_GNORM_RTOL
            or max(mods.values()) > PLANS_GRAD_L2 or bn > PLANS_GRAD_L2):
        fail(f"{what}: the sorted and dense train steps disagree")
    return dict(launches=launches, peaks=peaks, loss_err=loss_err,
                grad_norm=norm, modules=mods, bn_update=bn)


def run_phase15(torch, np, device, cfg, model_dev, train_ref=None,
                lr_inputs=None) -> dict:
    """Phase 15: model.plan_lookup="sorted", the rulebook with no index
    map. 15a K18-K20 bitwise against their plain versions and the dense
    maps' plans on phase 6's 4 car scans at batch 1, phase 7's train
    batch of 2, phase 9's long-range timing scan and its comparison
    batch's 8 band rows (with their y limits), and on the search edge
    cases (search_edges); their rows (K18 at phase 6's scan 0, K19 and
    K20 at phase 7's batch), each with its readings at the other shapes
    under "shapes" (K18 at phase 7's batch, the timing scan and the band
    rows, K19 and K20 at the band rows; sorted_at); 15b serving
    (sorted_serving); 15c phase 7's car train step and 15d phase 9's
    banded long-range train step at batch 2, sorted against dense
    (sorted_train_steps). `train_ref` (phase 7's batch and anchors) and
    `lr_inputs` (phase 9's banded config, samples and anchors) are made
    here when not given. Returns the rows and 15b-d's results."""
    import dataclasses
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.models.backbone import level_shapes
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    t = time.perf_counter()
    shapes = level_shapes(cfg.sparse_shape)
    caps = cfg.caps.level_caps[1:]
    rows, checks = [], []
    with tempfile.TemporaryDirectory() as root:
        cfg_pts, ds, step, batch1, _ = serving_split(torch, np, device, cfg,
                                                     root)
        lattice = serve.serving_lattice(cfg_pts, ds.anchors_bv).to(device)
        scans = []
        for i, b in enumerate(batch1):
            pts, n = (torch.from_numpy(b[k]).to(device)
                      for k in ("points", "n_points"))
            scans.append(sp.coords_to_keys(serve.batch_from_points(
                pts, n, lattice, cfg_pts)["coords"], shapes[0]))
            checks.append(sorted_check(
                torch, sp, f"phase 6's scan {i}, batch 1",
                sorted_levels(sp, scans[-1], shapes, caps), shapes))
        extra = {"K18": {}, "K19": {}, "K20": {}}
        rows.append(sorted_row(torch, "K18", "sorted_window_plans", sorted_at(
            torch, sp, "K18", sorted_levels(sp, scans[0], shapes, caps),
            shapes, "phase 6's scan 0, batch 1: a scan's six plans in one "
            "call", calls=True), "sassd_tpu/ops/sparse.py:129",
            extra["K18"]))
        checks += search_edges(torch, np, sp, device)
        t_a = time.perf_counter()
        serving = sorted_serving(torch, np, device, cfg_pts, ds, step,
                                 batch1, model_dev, scans[0])
    t_b = time.perf_counter()
    if train_ref is None:
        with tempfile.TemporaryDirectory() as root:
            batch, anchors = train_split_batch(np, cfg, root)
    else:
        batch, anchors = train_ref["batch"], train_ref["anchors"]
    batch = {k: v for k, v in batch.items() if not k.startswith("plan_")}
    keys = sorted_levels(sp, sp.coords_to_keys(torch.from_numpy(
        batch["coords"]).to(device), shapes[0]), shapes, caps)
    checks.append(sorted_check(torch, sp, "phase 7's train batch of 2",
                               keys, shapes))
    extra["K18"]["car b2"] = sorted_at(
        torch, sp, "K18", keys, shapes,
        "phase 7's train batch of 2, a scan's six plans in one call")
    what = "phase 7's train batch of 2, the three levels in one call"
    for kid, name, line in (("K19", "sorted_stride_plans_T", 732),
                            ("K20", "sorted_aux_plans", 785)):
        rows.append(sorted_row(torch, kid, name, sorted_at(
            torch, sp, kid, keys, shapes, what, calls=True),
            f"sassd_tpu/ops/sparse.py:{line}", extra[kid]))
    train_rulebook = {"car": rulebook_turns(
        sp, "15c: phase 7's train batch of 2, train=True with the aux plans",
        keys[0], shapes, caps, train=True)}
    del keys
    t_c = time.perf_counter()
    cfg_dev = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, host_plans=False))
    train = sorted_train_steps(torch, device, cfg_dev, batch,
                               anchors.to(device),
                               "15c, car training, batch 2",
                               "K1 K3 K3b K4 K5 K5b K7 K10 K11 K12 K18 K19 "
                               "K20")
    t_d = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        if lr_inputs is None:
            lr = long_range_inputs(np, root, timing=False)
            lr_inputs = dict(cfg_b=lr["cfg_b"], samples=lr["samples"],
                             anchors=lr["ds"].anchors)
    cfg_b = lr_inputs["cfg_b"]
    spec = ss.config_band_spec(cfg_b)
    lshapes = level_shapes(cfg_b.sparse_shape)
    t_scan = kitti.prepare_scan(cfg_b, synthetic.long_range_scene(
        np.random.default_rng(SEED + 10))[0], kitti.build_anchors(cfg_b)[1])
    keys = sorted_levels(sp, sp.coords_to_keys(torch.from_numpy(
        t_scan["coords"][None]).to(device), lshapes[0]), lshapes,
        cfg_b.caps.level_caps[1:])
    lr_scan = sorted_check(torch, sp, "phase 9's long-range timing scan",
                           keys, lshapes)
    checks.append(lr_scan)
    extra["K18"]["long range"] = dict(sorted_at(
        torch, sp, "K18", keys, lshapes, "phase 9's long-range timing scan"),
        valid_keys=lr_scan["valid_keys"])
    lr_batch = kitti.collate(lr_inputs["samples"])[0]
    coords = torch.from_numpy(lr_batch["coords"]).to(device)
    bc, _, _ = ss.partition(coords, torch.zeros(
        coords.shape[:2] + (4,), device=device), spec)
    bshapes = level_shapes(ss.band_shape(cfg_b, spec))
    keys = sorted_levels(
        sp, sp.coords_to_keys(bc.reshape(-1, bc.shape[2], 3), bshapes[0]),
        bshapes, spec.caps[1:],
        ss.y_top_rows(cfg_b, spec, coords.shape[0], device))
    band = f"phase 9's {keys[0].shape[0]} band rows"
    checks.append(sorted_check(torch, sp, band, keys, bshapes))
    for kid in ("K18", "K19", "K20"):
        extra[kid]["band rows"] = sorted_at(torch, sp, kid, keys, bshapes,
                                            band)
    train_rulebook["banded"] = rulebook_turns(
        sp, f"15d: phase 9's {keys[0].shape[0]} band rows, train=True with "
        f"the aux plans", keys[0], bshapes, spec.caps[1:], train=True,
        y_top=ss.y_top_rows(cfg_b, spec, coords.shape[0], device))
    del keys
    banded = sorted_train_steps(
        torch, device, cfg_b, lr_batch,
        torch.from_numpy(lr_inputs["anchors"]).to(device),
        "15d, long range banded training, batch 2",
        "K1 K3 K3b K4 K5 K5b K7 K10 K11 K12 K16 K18 K19 K20")
    for row in rows:            # every check of the kernel, not a constant
        kid = row["name"].split()[0]
        row["max_abs_err"] = max(c["err"][kid] for c in checks)
    wall = time.perf_counter() - t
    print(f"sorted plan lookups: phase 15 took {wall:.1f} s (15a serving "
          f"scans {t_a - t:.1f}, 15b {t_b - t_a:.1f}, 15a train batch "
          f"{t_c - t_b:.1f}, 15c {t_d - t_c:.1f}, 15a long range and 15d "
          f"{t + wall - t_d:.1f})")
    return dict(rows=rows, serving=serving, train=train, banded=banded,
                train_rulebook=train_rulebook, wall_s=wall)


def peak_phases(torch, np, device, cfg, model_dev, model_cpu, root: str,
                phase: str, host_step_ms=()):
    """Phase 6 (serving), 8 (three-class training on device plans) or 9
    (long range) under peak_mib: its results and {phase: its memory}. The
    device rulebook's maps live together while its plans are built, so
    these phases' peaks can move with it."""
    if phase == "6":
        fn = lambda: run_serving(torch, np, device, cfg, model_dev,  # noqa
                                 model_cpu, root)
    elif phase == "8":
        fn = lambda: run_multi_training(torch, np, device, root,  # noqa
                                        list(host_step_ms))
    else:
        fn = lambda: run_long_range(torch, np, device, root)  # noqa
    out, peak = peak_mib(torch, fn)
    print(f"phase {phase}: peak device memory {peak['peak_mib']:.1f} MiB "
          f"(allocated at its start {peak['start_mib']:.1f} MiB)")
    return out, {phase: peak}


TRAIN_PHASE_IDS = "K1 K3 K3b K4 K5 K5b K10 K11 K12"
SERVE_PHASE_IDS = "K1 K2 K3 K4 K5 K6 K7 K8 K9"


def kernel_symbols() -> dict:
    """Kernel id -> the launch-count symbols of its entry points."""
    from sassd_tpu_torch import serve
    from sassd_tpu_torch.core import boxes
    from sassd_tpu_torch.ops import interpolate as itp
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.ops import voxelize as vox
    from sassd_tpu_torch.ops import warp
    from sassd_tpu_torch.parallel import sparse_spatial as ss
    return {"K1": ("sassd_riou_overlap",), "K2": ("sassd_nms_keep",),
            **warp.KERNEL_SYMBOLS, **sp.KERNEL_SYMBOLS,
            **vox.KERNEL_SYMBOLS, **serve.KERNEL_SYMBOLS,
            **itp.KERNEL_SYMBOLS, **boxes.KERNEL_SYMBOLS,
            **ss.KERNEL_SYMBOLS, "K7'": sp.KERNEL_SYMBOLS["K7"],
            "K11'": itp.KERNEL_SYMBOLS["K11"]}


# the device rulebook's C calls on a path: K6's maps (levels 0-2, and
# level 3 when training) and one call of K6's plans a rulebook; persistent
# serving one K17 call (the three levels) and one plans call a scan
RULEBOOK_CALLS = {
    "inference": {"sassd_index_map": 3, "sassd_window_plans": 1},
    "training": {"sassd_index_map": 4, "sassd_window_plans": 1},
    "persistent": {"sassd_index_maps_update": 1, "sassd_index_map": 0,
                   "sassd_window_plans": 1},
    "12a": {"sassd_index_map": 10, "sassd_window_plans": 3}}


def check_counts(launches: dict, want: dict, what: str) -> None:
    """Print the launches of the entry points in `want` and fail unless
    each launched exactly as often as `want` says."""
    seen = {k: launches[k] for k in want}
    print(f"{what}: rulebook launches {seen} (want {want})")
    if seen != want:
        fail(f"{what}: the rulebook launched {seen}, not {want}")


def peak_mib(torch, fn):
    """fn()'s result and the card's memory around it: allocated at the
    start, torch.cuda.max_memory_allocated over the call (MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated() / 2**20
    out = fn()
    torch.cuda.synchronize()
    return out, dict(start_mib=start,
                     peak_mib=torch.cuda.max_memory_allocated() / 2**20)


def check_launched(launches: dict, ids: str, what: str) -> None:
    """Fail unless every kernel of `ids` launched in `launches`."""
    symbols = kernel_symbols()
    idle = [s for k in ids.split() for s in symbols[k] if launches[s] == 0]
    if idle:
        fail(f"{what}: a kernel of the path was not launched: {idle}")


def write_dp_splits(root: str) -> None:
    """Phase 10's data under root: phase 7's 4-scan train split (its seed)
    and phase 6's 4-scan val split."""
    from sassd_tpu_torch.data import synthetic
    synthetic.write_synthetic_kitti(os.path.join(root, "train"),
                                    n_train=N_SCANS, n_val=0, seed=SEED + 3)
    synthetic.write_synthetic_kitti(os.path.join(root, "val"), n_train=0,
                                    n_val=N_SCANS, seed=SEED)


def dp_data(cfg, root: str):
    """Phase 10's inputs from the splits under root. Returns (train
    dataset, val dataset, the points-serving config, the train samples of
    the DP_STEPS global batches of 2, the label directory)."""
    import dataclasses
    from sassd_tpu_torch.data import kitti
    tr, va = os.path.join(root, "train"), os.path.join(root, "val")
    train_ds = kitti.KittiDataset(cfg, os.path.join(tr, "training"),
                                  os.path.join(tr, "ImageSets", "train.txt"),
                                  train=True)
    cfg_pts = dataclasses.replace(cfg, test=dataclasses.replace(
        cfg.test, device_input="points"))
    val_ds = kitti.KittiDataset(cfg, os.path.join(va, "training"),
                                os.path.join(va, "ImageSets", "val.txt"))
    samples = [train_ds[i] for i in range(2 * DP_STEPS)]
    return (train_ds, val_ds, cfg_pts, samples,
            os.path.join(va, "training", "label_2"))


def dp_steps(torch, device, cfg, anchors, batches):
    """DP_STEPS train steps from phase 7's start weights (seed SEED), one
    per batch, with the launch counters reset just before and read just
    after. Returns (metrics per step as floats, step 1's .grad (CPU), the
    BatchNorm buffers after step 1's forward, the final state dict (CPU),
    launches)."""
    from sassd_tpu_torch.train import loop, optim
    from sassd_tpu_torch.weights import seeded_detector
    model = seeded_detector(cfg, SEED, device)
    opt = optim.make_optimizer(model, cfg.train, DP_STEPS)
    step = loop.make_train_step(cfg, anchors, opt, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    metrics, grads, bn = [], None, None
    for b in batches:
        m = step(model, b)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in model.named_parameters()}
            bn = {k: v.detach().cpu().clone()
                  for k, v in model.named_buffers()
                  if k.rsplit(".", 1)[-1] in ("mean", "var")}
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    state = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    return metrics, grads, bn, state, launches


def max_abs_diff(torch, a: dict, b: dict) -> float:
    """Largest |a - b| over the entries of two dicts of tensors or
    floats (0.0 when every entry is bitwise equal)."""
    out = 0.0
    for k in a:
        x, y = a[k], b[k]
        if torch.is_tensor(x):
            if not torch.equal(x, y):
                out = max(out, float((x.double() - y.double()).abs().max()))
        elif x != y:
            out = max(out, abs(x - y))
    return out


def module_l2(torch, got: dict, ref: dict) -> dict:
    """Each module's gradients' relative L2 distance from `ref`."""
    out = {}
    for mod in ("vxnet", "bevnet", "head", "pswarp", "aux"):
        keys = [k for k in ref if k.startswith(mod + ".")]
        num = sum(float(torch.sum((got[k].double() - ref[k].double()) ** 2))
                  for k in keys)
        den = sum(float(torch.sum(ref[k].double() ** 2)) for k in keys)
        out[mod] = (num / max(den, 1e-300)) ** 0.5
    return out


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_dp_world_one(torch, device, cfg, anchors, batches):
    """Phase 10a: the steps with no group, in a one-rank group of the
    device's backend (NCCL on the card), and with no group again. Returns
    the three runs (dp_steps' tuples) and the coalesced reductions' in ==
    out flags of the group's run."""
    from sassd_tpu_torch.parallel import dist
    ref = dp_steps(torch, device, cfg, anchors, batches)
    copies = []
    reduce = dist.all_reduce_coalesced

    def keep(tensors):
        before = [t.clone() for t in tensors]
        reduce(tensors)
        copies.append(all(torch.equal(a, b)
                          for a, b in zip(before, tensors)))
    for attempt in range(3):
        try:
            dist.initialize(f"localhost:{free_port()}", 1, 0, device=device,
                            timeout_s=DP_GROUP_TIMEOUT_S)
            break
        except RuntimeError as e:
            if attempt == 2 or not any(s in str(e).lower()
                                       for s in ADDR_IN_USE):
                raise
    dist.all_reduce_coalesced = keep
    try:
        backend = torch.distributed.get_backend()
        group = dp_steps(torch, device, cfg, anchors, batches)
    finally:
        dist.all_reduce_coalesced = reduce
        dist.shutdown()
    again = dp_steps(torch, device, cfg, anchors, batches)
    return ref, group, again, copies, backend


def dp_worker(argv) -> int:
    """One rank of phase 10b/10c, started by run_dp_ranks: argv = rank,
    world, port, job file (a torch.save of the config, the device and the
    paths). Joins the gloo group, runs the steps on its slice of each
    global batch and evaluate at batch 1, and saves what the parent
    checks."""
    rank, world, port, job_path = (int(argv[0]), int(argv[1]),
                                   int(argv[2]), argv[3])
    sys.path.insert(0, HERE)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.parallel import dist
    from sassd_tpu_torch.weights import seeded_detector
    job = torch.load(job_path, weights_only=False)
    device = torch.device(job["device"])
    cfg = job["cfg"]
    dist.initialize(f"localhost:{port}", world, rank, backend="gloo",
                    device=device, timeout_s=DP_GROUP_TIMEOUT_S)
    train_ds, val_ds, cfg_pts, samples, label_dir = dp_data(cfg, job["root"])
    local = [kitti.collate([samples[world * t + rank]])[0]
             for t in range(DP_STEPS)]
    metrics, grads, bn, state, launches = dp_steps(
        torch, device, cfg, train_ds.anchors, local)

    gathered = []
    gather = dist.gather_objects

    def keep(obj, *args, **kw):
        parts = gather(obj, *args, **kw)
        gathered.append(parts)
        return parts
    dist.gather_objects = keep
    model = seeded_detector(cfg, SEED, device)
    reset_launches()
    results, text = inference.evaluate(
        cfg_pts, val_ds, model, label_dir, 1, device,
        exchange_dir=os.path.join(job["out"], "exchange"))
    if device.type == "cuda":
        torch.cuda.synchronize()
    torch.save(dict(metrics=metrics, grads=grads, bn=bn, state=state,
                    launches=launches, eval_launches=read_launches(),
                    results=results, text=text, parts=gathered[0]),
               os.path.join(job["out"], f"rank{rank}.pt"))
    dist.barrier("dp_worker_done")
    dist.shutdown()
    return 0


def run_dp_ranks(torch, device, cfg, root: str, world: int = 2):
    """Phase 10b/10c: `world` rank subprocesses of this script on
    `device`, each with a time limit (all killed at the first one over
    it). Returns their saved results, rank order."""
    out = os.path.join(root, "ranks")
    os.makedirs(out, exist_ok=True)
    job = os.path.join(out, "job.pt")
    torch.save(dict(cfg=cfg, device=str(device), root=root, out=out), job)
    for attempt in range(3):
        port = free_port()
        logs = [open(os.path.join(out, f"rank{r}_try{attempt}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker",
             str(r), str(world), str(port), job],
            stdout=logs[r], stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        deadline = time.time() + DP_WORKER_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            over = [p for p in procs if p.poll() is None]
            for p in over:
                p.kill()
                p.wait()
        text = []
        for f in logs:
            f.seek(0)
            text.append(f.read())
            f.close()
        if over:
            fail(f"data-parallel: a rank outlived {DP_WORKER_TIMEOUT_S} s:\n"
                 + "\n".join(t[-3000:] for t in text))
        if all(p.returncode == 0 for p in procs):
            return [torch.load(os.path.join(out, f"rank{r}.pt"),
                               weights_only=False) for r in range(world)]
        taken = any(s in t.lower() for t in text for s in ADDR_IN_USE)
        if not taken or attempt == 2:
            bad = next(t for p, t in zip(procs, text) if p.returncode)
            fail(f"data-parallel: a rank failed:\n{bad[-4000:]}")
    raise AssertionError("unreachable")


def run_data_parallel(torch, np, device, cfg, root: str) -> dict:
    """Phase 10 (see the module docstring). Returns the printed numbers."""
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.weights import seeded_detector
    t0 = time.perf_counter()
    write_dp_splits(root)
    train_ds, val_ds, cfg_pts, samples, label_dir = dp_data(cfg, root)
    batches = [kitti.collate(samples[2 * t:2 * t + 2])[0]
               for t in range(DP_STEPS)]
    anchors = train_ds.anchors

    # 10a: world size 1
    ref, group, again, copies, backend = run_dp_world_one(
        torch, device, cfg, anchors, batches)
    check_launched(group[4], TRAIN_PHASE_IDS,
                   f"data-parallel, world size 1 ({backend})")
    print(f"data-parallel, world size 1 ({backend}): launches {group[4]}")
    (rm, rg, rbn, rs, _), (gm, gg, gbn, gs, _), (am, ag, abn, as_, _) = (
        ref, group, again)
    pairs = {"group vs none": (gm, gg, gbn, gs), "none vs none": (am, ag,
                                                                 abn, as_)}
    diffs = {}
    for what, (m, g, bn, st) in pairs.items():
        loss1 = max_abs_diff(torch, {k: v for k, v in m[0].items()
                                     if k != "grad_norm"},
                             {k: v for k, v in rm[0].items()
                              if k != "grad_norm"})
        diffs[what] = dict(
            losses_step1=loss1, bn_step1=max_abs_diff(torch, bn, rbn),
            grad_norms=max(abs(a["grad_norm"] - b["grad_norm"])
                           for a, b in zip(m, rm)),
            losses=max(max_abs_diff(torch, a, b) for a, b in zip(m, rm)),
            grads_step1=max_abs_diff(torch, g, rg),
            state=max_abs_diff(torch, st, rs),
            module_l2=max(module_l2(torch, g, rg).values()))
        print(f"data-parallel, world size 1, {what}: largest |difference| "
              + ", ".join(f"{k} {v:.3g}" for k, v in diffs[what].items()))
    if not (copies and all(copies) and len(copies) == DP_STEPS):
        fail(f"data-parallel, world size 1: the coalesced all-reduce is "
             f"not a copy ({copies})")
    d, ctl = diffs["group vs none"], diffs["none vs none"]
    for k in ("losses_step1", "bn_step1"):
        if d[k] != 0.0:
            fail(f"data-parallel, world size 1: {k} differ from the run "
                 f"with no group by {d[k]:.3g}")
    repeatable = all(v == 0.0 for v in ctl.values())
    if repeatable:
        bad = [k for k, v in d.items() if v != 0.0]
        if bad:
            fail(f"data-parallel, world size 1: {bad} differ from the "
                 f"run with no group, which repeats itself bitwise")
    else:
        # the backward's atomics (K11) add in another order each run:
        # step 1's gradients are held to phase 8's tolerances for runs
        # apart by that order alone; the later steps follow Adam's
        # updates of those gradients and are printed beside the control
        gn_err = (abs(gm[0]["grad_norm"] - rm[0]["grad_norm"])
                  / rm[0]["grad_norm"])
        if gn_err > PLANS_GNORM_RTOL or d["module_l2"] > PLANS_GRAD_L2:
            fail(f"data-parallel, world size 1: step 1's grad norm "
                 f"{gn_err:.3g}, module L2 {d['module_l2']:.3g} apart from "
                 f"the run with no group")
        print(f"data-parallel, world size 1: the run with no group does "
              f"not repeat itself bitwise (the backward's atomics), so "
              f"step 1's gradients are held to phase 8's atomics-order "
              f"tolerances: grad norm {gn_err:.3g} (<= {PLANS_GNORM_RTOL}),"
              f" module L2 {d['module_l2']:.3g} (<= {PLANS_GRAD_L2}); the "
              f"later steps are not gated")
    print(f"data-parallel, world size 1: step 1's losses and BatchNorm "
          f"buffers bitwise equal to the run with no group; the "
          f"{len(copies)} coalesced reductions are copies")

    # 10b and 10c: two ranks on the one device over gloo
    if device.type == "cuda":
        torch.cuda.empty_cache()        # the ranks' room on the card
    t = time.perf_counter()
    ranks = run_dp_ranks(torch, device, cfg, root)
    ranks_s = time.perf_counter() - t
    for r, res in enumerate(ranks):
        check_launched(res["launches"], TRAIN_PHASE_IDS,
                       f"data-parallel, rank {r} of 2, training")
        check_launched(res["eval_launches"], SERVE_PHASE_IDS,
                       f"data-parallel, rank {r} of 2, evaluate")
    r0, r1 = ranks
    rank_diff = max_abs_diff(torch, r0["state"], r1["state"])
    if rank_diff != 0.0 or r0["metrics"] != r1["metrics"]:
        fail(f"data-parallel, 2 ranks: the replicas differ after "
             f"{DP_STEPS} steps (largest |difference| {rank_diff:.3g})")
    m1, ref1 = r0["metrics"][0], rm[0]
    loss_err = {k: abs(m1[k] - v) / abs(v) for k, v in ref1.items()
                if "loss" in k}
    gn_err = abs(m1["grad_norm"] - ref1["grad_norm"]) / ref1["grad_norm"]
    mod_err = module_l2(torch, r0["grads"], rg)
    print(f"data-parallel, 2 ranks over gloo on one card: replicas bitwise "
          f"equal after {DP_STEPS} steps; step 1 against the single-process "
          f"batch-2 step: losses rel {max(loss_err.values()):.3g} "
          f"(<= {TRAIN_LOSS_RTOL}), grad norm {m1['grad_norm']:.7g} vs "
          f"{ref1['grad_norm']:.7g} rel {gn_err:.3g} (<= {TRAIN_GNORM_RTOL}),"
          f" module rel L2 " + ", ".join(f"{k} {v:.3g}" for k, v in
                                          mod_err.items())
          + f" (<= {TRAIN_GRAD_L2}); guided_valid {m1['guided_valid']:g} vs "
          f"{ref1['guided_valid']:g}, guided_pos {m1['guided_pos']:g} vs "
          f"{ref1['guided_pos']:g}")
    bad = [k for k, v in loss_err.items() if not v <= TRAIN_LOSS_RTOL]
    if (bad or not gn_err <= TRAIN_GNORM_RTOL
            or max(mod_err.values()) > TRAIN_GRAD_L2):
        fail(f"data-parallel, 2 ranks: step 1 disagrees with the "
             f"single-process step on {bad or 'the gradients'}")

    if (r1["results"], r1["text"], r1["parts"]) != (None, "", None):
        fail("data-parallel, evaluate: rank 1 returned a result")
    parts = r0["parts"]
    annos, ids = inference._dedup_by_id(
        [a for p in parts for a in p[0]], [i for p in parts for i in p[1]])
    model = seeded_detector(cfg, SEED, device)
    ref_annos, ref_ids = inference._dedup_by_id(*inference.run_inference(
        cfg_pts, val_ds, model, 1, device))
    if ids != ref_ids:
        fail(f"data-parallel, evaluate: samples {ids} vs {ref_ids}")
    counts = [match_annos(np, a, b, f"data-parallel, evaluate, sample {i}")
              for a, b, i in zip(annos, ref_annos, ids)]
    _, ref_text = inference.evaluate(cfg_pts, val_ds, None, label_dir,
                                     precomputed=(ref_annos, ref_ids))
    same = "equal" if r0["text"] == ref_text else "DIFFERENT"
    print(f"data-parallel, evaluate on 2 ranks: rank 0 gathered "
          f"{[len(p[1]) for p in parts]} samples, detections match the "
          f"single-process run_inference on {len(ids)} scans ({counts} "
          f"detections); AP table {same} to the single-process one (not "
          f"gated)")
    wall = time.perf_counter() - t0
    print(f"data-parallel: phase 10 took {wall:.1f} s (the two rank "
          f"processes {ranks_s:.1f} s)")
    return dict(wall_s=wall, ranks_s=ranks_s, world1=diffs,
                ranks_state_diff=rank_diff, loss_err=loss_err,
                gnorm_err=gn_err, module_l2=mod_err, detections=counts)


CLI_MULTI_IDS = "K1 K3 K3b K4 K5 K5b K6 K7 K10 K11 K12 K13 K14"
CLI_TEST_IDS = "K1 K2 K3 K4 K5"


def cli_worker(argv) -> int:
    """One CLI process of phase 11: argv = record file, tool name, the
    tool's arguments. Runs ``sassd_tpu_torch.tools.<tool>.main`` with the
    launch counters reset just before and read just after, records every
    train step's metrics (loop.make_train_step wrapped), the optimizer's
    final count and hyperparameters and its weight-decay scope, and
    run_inference's annotations, and pickles them to the record file."""
    out, name, args = argv[0], argv[1], argv[2:]
    sys.path.insert(0, HERE)
    import importlib
    import pickle
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.train import loop
    rec = {"steps": [], "annos": None}
    make_step, run_inf = loop.make_train_step, inference.run_inference

    def make_train_step(cfg, anchors, optimizer, device):
        step = make_step(cfg, anchors, optimizer, device)
        rec["optimizer"] = optimizer

        def recorded(model, batch):
            m = step(model, batch)
            rec["steps"].append({k: float(v) for k, v in m.items()})
            return m
        return recorded

    def run_inference(*a, **kw):
        rec["annos"] = run_inf(*a, **kw)
        return rec["annos"]
    loop.make_train_step, inference.run_inference = make_train_step, \
        run_inference
    tool = importlib.import_module(f"sassd_tpu_torch.tools.{name}")
    reset_launches()
    rc = tool.main(args)
    rec.update(rc=rc, launches=read_launches())
    opt = rec.pop("optimizer", None)
    if opt is not None:
        rec.update(count=opt.count, hyperparams=opt.hyperparams(),
                   decay_all=all(opt.decay.values()))
    with open(out, "wb") as f:
        pickle.dump(rec, f)
    return rc


def start_cli(root: str, tag: str, tool: str, *args):
    """Start one CLI process of phase 11 (cli_worker) in the background;
    its output goes to root/{tag}.log, its record to root/{tag}.pkl."""
    log = open(os.path.join(root, f"{tag}.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cli-worker",
         os.path.join(root, f"{tag}.pkl"), tool, *args],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT, text=True)
    return dict(tag=tag, proc=proc, log=log, root=root,
                t0=time.perf_counter())


def finish_cli(run: dict, want_rc: int = 0) -> dict:
    """Wait for a CLI process (killed past CLI_TIMEOUT_S) and return its
    record with its output ("text") and wall seconds; fail unless it
    exited `want_rc`."""
    import pickle
    proc = run["proc"]
    try:
        proc.wait(timeout=max(CLI_TIMEOUT_S - (time.perf_counter()
                                               - run["t0"]), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    run["log"].seek(0)
    text = run["log"].read()
    run["log"].close()
    if proc.returncode != want_rc:
        fail(f"CLI {run['tag']}: exit {proc.returncode}, not {want_rc}:\n"
             f"{text[-4000:]}")
    with open(os.path.join(run["root"], f"{run['tag']}.pkl"), "rb") as f:
        rec = pickle.load(f)
    rec.update(text=text, wall_s=time.perf_counter() - run["t0"])
    print(f"  CLI {run['tag']}: exit {proc.returncode} in "
          f"{rec['wall_s']:.1f} s, {len(rec['steps'])} train steps")
    return rec


def wrapper_config(root: str, name: str, base: str, **replace) -> str:
    """A config file under root that loads the config file `base` and
    replaces the given fields (sections as dicts of fields); returns its
    path."""
    lines = ["import dataclasses",
             "from sassd_tpu.config import load_config",
             f"_c = load_config({base!r})"]
    fields = []
    for k, v in replace.items():
        if isinstance(v, dict):
            inner = ", ".join(f"{f}={x!r}" for f, x in v.items())
            fields.append(f"{k}=dataclasses.replace(_c.{k}, {inner})")
        else:
            fields.append(f"{k}={v!r}")
    lines.append(f"config = dataclasses.replace(_c, {', '.join(fields)})")
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def check_train_record(np, rec: dict, n_steps: int, what: str) -> None:
    """Every recorded step finite with no skipped update."""
    if len(rec["steps"]) != n_steps:
        fail(f"{what}: {len(rec['steps'])} train steps, not {n_steps}")
    for i, m in enumerate(rec["steps"]):
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"{what}: step {i}: a non-finite metric {m}")
        if m["nonfinite_skips"]:
            fail(f"{what}: step {i} skipped its update")


def run_pointnet_vfe(torch, np, device, cfg, root: str) -> dict:
    """Phase 11d: the PointNet VFE on `cfg` (the car config) on the card
    against the CPU: forward_test detections as sets, and one train
    step's losses against the CPU forward_train's (TRAIN_LOSS_RTOL)."""
    import dataclasses
    from sassd_tpu_torch import inference
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.data.loader import iterate_batches
    from sassd_tpu_torch.train import loop, optim
    from sassd_tpu_torch.weights import seeded_detector
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, vfe_type="pointnet"))
    synthetic.write_synthetic_kitti(
        root, n_train=2, n_val=0, seed=SEED + 5,
        point_cloud_range=cfg.voxel.point_cloud_range)
    ds = kitti.KittiDataset(cfg, os.path.join(root, "training"),
                            os.path.join(root, "ImageSets", "train.txt"),
                            train=True)
    batch = next(iter(iterate_batches(ds, 2, shuffle=False,
                                      num_workers=0)))[0]
    model_dev = seeded_detector(cfg, SEED, device)
    model_cpu = seeded_detector(cfg, SEED, "cpu")
    dets = {}
    for where, model, dev in (("card", model_dev, device),
                              ("cpu", model_cpu, "cpu")):
        step = inference.make_test_step(cfg, ds.anchors, dev)
        dets[where] = {k: v.cpu().numpy()
                       for k, v in step(model, batch).items()}
    n = [match_detections({k: v[i] for k, v in dets["card"].items()},
                          {k: v[i] for k, v in dets["cpu"].items()},
                          f"PointNet VFE, scan {i}: card vs CPU")
         for i in range(2)]
    if sum(n) == 0:
        fail("PointNet VFE: no detections to compare")
    model_cpu.train()
    with torch.no_grad():
        ref = model_cpu.forward_train(
            inference.to_device(batch, "cpu"),
            torch.from_numpy(ds.anchors))
    opt = optim.make_optimizer(model_dev, cfg.train, 10)
    got = loop.make_train_step(cfg, ds.anchors, opt, device)(model_dev,
                                                             batch)
    worst = 0.0
    for k, v in ref.items():
        if "loss" not in k:
            continue
        r, g = float(v), float(got[k])
        err = abs(g - r) / max(abs(r), 1e-12)
        worst = max(worst, err)
        if not err <= TRAIN_LOSS_RTOL:
            fail(f"PointNet VFE: train step {k} card {g} vs CPU {r} "
                 f"({err:.2e} > {TRAIN_LOSS_RTOL})")
    if float(got["nonfinite_skips"]):
        fail("PointNet VFE: the card's train step skipped its update")
    print(f"PointNet VFE (car width): detections card vs CPU matched "
          f"{n}; one train step's losses within {worst:.2e} of the CPU's")
    return dict(matched=n, loss_rel=worst)


def run_cli(torch, np, device, root: str) -> dict:
    """Phase 11 (see the module docstring). Returns the printed numbers."""
    import dataclasses
    from sassd_tpu_torch.config import load_config
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.data.loader import iterate_batches
    from sassd_tpu_torch.inference import evaluate, run_inference
    from sassd_tpu_torch.models.detector import Detector
    from sassd_tpu_torch.tools import make_synth_corpus
    from sassd_tpu_torch.train import checkpoint as ckpt, loop, optim
    t0 = time.perf_counter()
    car = CLI_CAR
    # the CLIs run on the card by default; a CPU rehearsal asks for the CPU
    dev_args = [] if device.type == "cuda" else ["--device", "cpu"]
    work = {k: os.path.join(root, k)
            for k in ("whole", "whole2", "split", "multi")}
    corpus = os.path.join(root, "multi_corpus")
    make_synth_corpus.main([corpus, "--n_train", str(CLI_CORPUS[0]),
                            "--n_val", str(CLI_CORPUS[1]),
                            "--seed", str(SEED)])
    multi_cfg = wrapper_config(
        root, "multi_r3.py", CLI_MULTI,
        data=dict(root=corpus,
                  info_path=os.path.join(corpus, "ImageSets", "train.txt"),
                  db_info_path=os.path.join(corpus,
                                            "kitti_dbinfos_train.pkl")),
        train=dict(total_epochs=1), work_dir=work["multi"])
    train_args = ["--synthetic", "--epochs", str(CLI_EPOCHS), *dev_args]
    runs = [start_cli(root, "whole", "train", car, "--work_dir",
                      work["whole"], *train_args),
            start_cli(root, "split1", "train", car, "--work_dir",
                      work["split"], *train_args, "--epochs_per_run", "1"),
            start_cli(root, "multi", "train", multi_cfg, *dev_args),
            # a second uninterrupted run: how far two runs drift apart
            # without a relaunch (the control of 11a's distance)
            start_cli(root, "whole2", "train", car, "--work_dir",
                      work["whole2"], *train_args)]
    try:
        vfe = run_pointnet_vfe(torch, np, device, load_config(car),
                               os.path.join(root, "vfe"))
        split1 = finish_cli(runs[1], 75)
        runs.append(start_cli(root, "split2", "train", car, "--work_dir",
                              work["split"], *train_args,
                              "--epochs_per_run", "1"))
        whole, multi = finish_cli(runs[0]), finish_cli(runs[2])
        whole2, split2 = finish_cli(runs[3]), finish_cli(runs[4])
    finally:
        for r in runs:
            if r["proc"].poll() is None:
                r["proc"].kill()
                r["proc"].wait()
    # 11a: the uninterrupted and the relaunched runs
    cfg = load_config(car)
    data = os.path.join(work["split"], "synthetic_kitti")
    ds = kitti.KittiDataset(cfg, os.path.join(data, "training"),
                            os.path.join(data, "ImageSets", "train.txt"),
                            train=True)
    spe = -(-len(ds) // cfg.train.batch_size)
    check_train_record(np, whole, spe * CLI_EPOCHS, "CLI whole")
    check_train_record(np, whole2, spe * CLI_EPOCHS, "CLI whole2")
    check_train_record(np, split1, spe, "CLI split, first launch")
    check_train_record(np, split2, spe * (CLI_EPOCHS - 1),
                       "CLI split, relaunch")
    for rec, what in ((whole, "CLI whole"), (split1, "CLI split1"),
                      (split2, "CLI split2")):
        check_launched(rec["launches"], TRAIN_PHASE_IDS, what)
    final = {k: torch.load(os.path.join(work[k],
                                        f"checkpoint_epoch_{CLI_EPOCHS - 1}"
                                        ".pt"), weights_only=True)
             for k in ("whole", "whole2", "split")}
    ends = {k: (final[k]["step"], final[k]["optimizer"]["count"], r["count"],
                r["hyperparams"]) for k, r in (("whole", whole),
                                               ("split", split2))}
    if ends["whole"] != ends["split"] or ends["whole"][0] != spe * CLI_EPOCHS:
        fail(f"CLI: (step, saved count, count, (lr, momentum)) whole "
             f"{ends['whole']} vs relaunched {ends['split']}")
    # how far apart two runs end: parameters by their largest difference
    # and relative L2, BatchNorm statistics by relative L2
    names = {k for k, _ in Detector(cfg).named_parameters()}

    def distance(a, b):
        def rel_l2(keys):
            num = sum(float(((a[k] - b[k]).double() ** 2).sum())
                      for k in keys)
            den = sum(float((a[k].double() ** 2).sum()) for k in keys)
            return (num / max(den, 1e-300)) ** 0.5
        return dict(param_max=max(float((a[k] - b[k]).abs().max())
                                  for k in names),
                    param_rel_l2=rel_l2(names),
                    bn_rel_l2=rel_l2([k for k in a if k not in names]))
    diff = {what: distance(final["whole"]["model"], final[k]["model"])
            for what, k in (("relaunched", "split"), ("control", "whole2"))}
    print(f"CLI 11a: whole and relaunched runs end at step "
          f"{ends['whole'][0]}, count {ends['whole'][1]}, lr/momentum "
          f"{ends['whole'][3]} (not gated below: K11's backward atomics)")
    for what, d in diff.items():
        print(f"CLI 11a: final weights, whole vs {what} "
              f"{'(a second uninterrupted run) ' if what == 'control' else ''}"
              f"parameters max |diff| {d['param_max']:.3e}, relative L2 "
              f"{d['param_rel_l2']:.3e}; BatchNorm statistics relative L2 "
              f"{d['bn_rel_l2']:.3e}")
    # the relaunch's first step against a step taken here from the same
    # checkpoint on the same batch
    model = Detector(cfg).to(device)
    opt = optim.make_optimizer(model, cfg.train, spe * CLI_EPOCHS)
    ckpt.restore(os.path.join(work["split"], "checkpoint_epoch_0.pt"), model,
                 opt)
    batch = next(iter(iterate_batches(ds, cfg.train.batch_size, epoch=1,
                                      seed=cfg.train.seed, shuffle=True,
                                      num_workers=0)))[0]
    here = {k: float(v) for k, v in loop.make_train_step(
        cfg, ds.anchors, opt, device)(model, batch).items()}
    first = split2["steps"][0]
    losses = [k for k in here if "loss" in k]
    off = [k for k in losses if here[k] != first[k]]
    if off or not losses:
        fail(f"CLI 11a: the relaunch's first step differs from the "
             f"in-process step from its checkpoint: "
             f"{[(k, first[k], here[k]) for k in off]}")
    print(f"CLI 11a: the relaunch's first step's {len(losses)} losses equal "
          f"the in-process step's bit for bit (loss {here['loss']:.6f})")
    # 11b: tools.test on the relaunched run's final checkpoint
    test_cfg = wrapper_config(root, "car_test.py", car, data=dict(root=data))
    final_pt = os.path.join(work["split"],
                            f"checkpoint_epoch_{CLI_EPOCHS - 1}.pt")
    out = os.path.join(root, "results")
    test = finish_cli(start_cli(root, "test", "test", test_cfg, final_pt,
                                "--out", out, *dev_args))
    check_launched(test["launches"], CLI_TEST_IDS, "CLI test")
    tcfg = load_config(test_cfg)
    val = kitti.KittiDataset(tcfg, os.path.join(data, "training"),
                             os.path.join(data, "ImageSets", "val.txt"))
    model = Detector(tcfg)
    ckpt.restore(final_pt, model)
    model.to(device)
    annos, ids = run_inference(tcfg, val, model, 1, device)
    got_annos, got_ids = test["annos"]
    if list(got_ids) != list(ids):
        fail(f"CLI test: samples {got_ids} vs {ids}")
    n_det = [match_annos(np, g, a, f"CLI test, scan {i}")
             for g, a, i in zip(got_annos, annos, ids)]
    _, text = evaluate(tcfg, val, model,
                       os.path.join(data, "training", "label_2"),
                       device=device, precomputed=(annos, ids))
    if text.strip() not in test["text"]:
        fail(f"CLI test: its AP text differs from evaluate's:\n{text}")
    files = sorted(os.listdir(out))
    if files != [f"{i:06d}.txt" for i in ids]:
        fail(f"CLI test: result files {files}")
    print(f"CLI 11b: tools.test matched the in-process run on {len(ids)} "
          f"scans ({n_det} detections), AP text equal, {len(files)} result "
          f"files")
    # 11c: configs/multi_convergence_r3.py on the small corpus
    n_multi = -(-CLI_CORPUS[0] // load_config(multi_cfg).train.batch_size)
    check_train_record(np, multi, n_multi, "CLI multi_convergence_r3")
    check_launched(multi["launches"], CLI_MULTI_IDS,
                   "CLI multi_convergence_r3")
    if not multi["decay_all"]:
        fail("CLI multi_convergence_r3: weight_decay_mode='all' did not "
             "decay every parameter")
    print(f"CLI 11c: multi_convergence_r3 ({n_multi} steps at batch 1, "
          f"device plans, weight decay on every parameter, GT database) "
          f"losses {[round(m['loss'], 4) for m in multi['steps']]}")
    wall = time.perf_counter() - t0
    procs = {k: r["wall_s"] for k, r in (
        ("whole", whole), ("whole2", whole2), ("split1", split1),
        ("split2", split2), ("multi", multi), ("test", test))}
    print(f"CLI: phase 11 took {wall:.1f} s (process wall s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in procs.items()) + ")")
    return dict(wall_s=wall, diff=diff, vfe=vfe, procs=procs)

# phase 12: the spatial strategies across rank subprocesses sharing the
# card over gloo: each rank's time limit, the collectives' timeout of
# every process group, and the kernels each rank's path must launch
SP_WORKER_TIMEOUT_S = 600
SP_GROUP_TIMEOUT_S = 300
SP_BANDED_IDS = "K1 K2 K3 K3b K4 K5 K5b K6 K7' K10 K11' K12 K13 K14 K16"
SP_SPATIAL_IDS = "K1 K2 K3 K3b K4 K5 K5b K6 K7 K10 K11 K12 K13 K14"
SP_STEPS = 2
PROBE_OPS = ("all_reduce", "all_gather", "send_recv")


def sp_configs(lr: dict) -> dict:
    """Phase 12's configs: 12a the user's banded layout (phase 9's cfg_b,
    4 bands), 12b the spatial strategy over 2 ranks on phase 9's
    replicated config (device plans), 12c banded over 2 bands."""
    import dataclasses
    from sassd_tpu_torch.config import ParallelConfig
    return {"12a": lr["cfg_b"],
            "12b": dataclasses.replace(lr["cfg_r"], parallel=ParallelConfig(
                strategy="spatial", spatial=2)),
            "12c": dataclasses.replace(lr["cfg_b"], parallel=ParallelConfig(
                strategy="banded", spatial=2))}


def sp_path(torch, device, cfg, lr: dict) -> dict:
    """One rank of 12a or 12b: forward_test at batch 1 on both comparison
    scans and one train step at batch 2 (lr_train_step, reduced over the
    ranks), from the seeded weights, with the launch counters reset just
    before and read just after."""
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step
    from sassd_tpu_torch.parallel import mesh
    from sassd_tpu_torch.weights import seeded_detector
    model = seeded_detector(cfg, SEED, device)
    ds = lr["ds"]
    anchors = torch.from_numpy(ds.anchors).to(device)
    step = make_test_step(cfg, ds.anchors, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    dets = [{k: v.cpu().numpy() for k, v in step(
        model, kitti.collate([s])[0]).items()} for s in lr["samples"]]
    train = lr_train_step(torch, device, cfg, model.state_dict(),
                          lr["batch"], anchors)
    return dict(layout=tuple(mesh.layout(cfg)[:4]), dets=dets, train=train,
                launches=read_launches(), s=time.perf_counter() - t)


def sp_train(torch, device, cfg, root: str, out: str) -> dict:
    """One rank of 12c: train_model for SP_STEPS steps at global batch 2
    over the long-range split, every step's metrics recorded; returns them
    with the final state (CPU) and the steps taken."""
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.train import loop
    ds = kitti.KittiDataset(cfg, os.path.join(root, "training"),
                            os.path.join(root, "ImageSets", "train.txt"),
                            train=True)
    metrics = []
    make_step = loop.make_train_step

    def recording(*args):
        step = make_step(*args)

        def run(model, batch):
            m = step(model, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            return m
        return run
    loop.make_train_step = recording
    try:
        model, opt, n = loop.train_model(
            cfg, ds, os.path.join(out, "work"),
            total_epochs=SP_STEPS * cfg.train.batch_size // N_SCANS,
            device=device, resume=False)
    finally:
        loop.make_train_step = make_step
    return dict(steps=n, updates=opt.count, metrics=metrics,
                state={k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()})


def sp_worker(argv) -> int:
    """One of phase 12's four rank processes, started by run_spatial:
    argv = rank, the three rounds' ports, the job file. Round 12a: the
    four ranks in a 1 x 4 banded group; 12b: ranks 0 and 1 in a 1 x 2
    spatial group (ranks 2 and 3 wait for round 12c); 12c: the four in a
    2 x 2 banded group. Every group runs over gloo on the one card."""
    rank, ports, job_path = int(argv[0]), [int(p) for p in argv[1:4]], argv[4]
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sassd_tpu_torch.parallel import dist
    job = torch.load(job_path, weights_only=False)
    device = torch.device(job["device"])
    lr = long_range_inputs(np, job["root"], write=False, timing=False,
                           cfgs=job["cfgs"])
    cfgs = sp_configs(lr)
    res = {}
    for name, port, world in (("12a", ports[0], 4), ("12b", ports[1], 2),
                              ("12c", ports[2], 4)):
        if rank >= world:
            continue
        dist.initialize(f"localhost:{port}", world, rank, backend="gloo",
                        device=device, timeout_s=SP_GROUP_TIMEOUT_S)
        if name == "12c":
            res[name] = sp_train(torch, device, cfgs[name], job["root"],
                                 job["out"])
        else:
            res[name] = sp_path(torch, device, cfgs[name], lr)
        dist.barrier(name)
        dist.shutdown()
    torch.save(res, os.path.join(job["out"], f"rank{rank}.pt"))
    return 0


def run_sp_ranks(torch, device, root: str, cfgs, world: int = 4):
    """Phase 12's `world` rank subprocesses of this script on `device`,
    each with a time limit (all killed at the first one over it), reading
    the configs `cfgs` (cfg_b, cfg_r) from their job file; a rendezvous
    port taken meanwhile is retried on fresh ones. Returns their saved
    results, rank order."""
    out = os.path.join(root, "spatial_ranks")
    os.makedirs(out, exist_ok=True)
    job = os.path.join(out, "job.pt")
    torch.save(dict(device=str(device), root=root, out=out, cfgs=cfgs), job)
    for attempt in range(3):
        ports = [str(free_port()) for _ in range(3)]
        logs = [open(os.path.join(out, f"rank{r}_try{attempt}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sp-worker",
             str(r), *ports, job],
            stdout=logs[r], stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        deadline = time.time() + SP_WORKER_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            over = [p for p in procs if p.poll() is None]
            for p in over:
                p.kill()
                p.wait()
        text = []
        for f in logs:
            f.seek(0)
            text.append(f.read())
            f.close()
        if over:
            fail(f"spatial: a rank outlived {SP_WORKER_TIMEOUT_S} s:\n"
                 + "\n".join(t[-3000:] for t in text))
        if all(p.returncode == 0 for p in procs):
            return [torch.load(os.path.join(out, f"rank{r}.pt"),
                               weights_only=False) for r in range(world)]
        taken = any(s in t.lower() for t in text for s in ADDR_IN_USE)
        if not taken or attempt == 2:
            bad = next(t for p, t in zip(procs, text) if p.returncode)
            fail(f"spatial: a rank failed:\n{bad[-4000:]}")
    raise AssertionError("unreachable")


def sp_references(torch, np, device, lr: dict) -> dict:
    """The single-process runs phase 12 is held to, as phase 9 makes them
    (phase 9's own when it ran in this process): both scans' batch-1
    detections and the batch-2 train step, banded and replicated."""
    from sassd_tpu_torch.data import kitti
    from sassd_tpu_torch.inference import make_test_step
    from sassd_tpu_torch.weights import seeded_detector
    anchors = torch.from_numpy(lr["ds"].anchors).to(device)
    refs = dict(dets={}, steps={})
    for what in ("banded", "replicated"):
        cfg = lr["cfg_b"] if what == "banded" else lr["cfg_r"]
        model = seeded_detector(cfg, SEED, device)
        step = make_test_step(cfg, lr["ds"].anchors, device)
        refs["dets"][what] = [{k: v.cpu().numpy() for k, v in step(
            model, kitti.collate([s])[0]).items()} for s in lr["samples"]]
        refs["steps"][what] = lr_train_step(torch, device, cfg,
                                            model.state_dict(), lr["batch"],
                                            anchors)
    return refs


def run_spatial(torch, np, device, root: str, refs=None) -> dict:
    """Phase 12 (see the module docstring). Returns the printed numbers and
    each rank's launches of 12a and 12b."""
    t0 = time.perf_counter()
    lr = long_range_inputs(np, root, timing=False)
    if refs is None:
        refs = sp_references(torch, np, device, lr)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()        # the ranks' room on the card
    t = time.perf_counter()
    ranks = run_sp_ranks(torch, device, root, (lr["cfg_b"], lr["cfg_r"]))
    ranks_s = time.perf_counter() - t
    gates = {}
    for name, ref, world, lay, ids in (
            ("12a", "banded", 4, (1, 4), SP_BANDED_IDS),
            ("12b", "replicated", 2, (1, 2), SP_SPATIAL_IDS)):
        runs = [r[name] for r in ranks[:world]]
        what = (f"spatial {name}, {ref if ref == 'banded' else 'spatial'} "
                f"over {world} ranks")
        for r, run in enumerate(runs):
            if run["layout"] != lay + (0, r):
                fail(f"{what}: rank {r} laid out as {run['layout']}")
            check_launched(run["launches"], ids, f"{what}, rank {r}")
            if name == "12a":
                # two forward_test rulebooks (three maps each) and one
                # train rulebook (four), each with one call of K6's plans
                check_counts(run["launches"], RULEBOOK_CALLS["12a"],
                             f"{what}, rank {r}")
        counts = [match_detections(d, e, f"{what}, rank {r}, scan {i}")
                  for r, run in enumerate(runs)
                  for i, (d, e) in enumerate(zip(run["dets"],
                                                 refs["dets"][ref]))]
        losses = [run["train"]["losses"] for run in runs]
        if any(m != losses[0] for m in losses):
            fail(f"{what}: the ranks' reduced losses differ: {losses}")
        if losses[0].get("band_overflow", 0.0) != 0.0:
            fail(f"{what}: band_overflow {losses[0]['band_overflow']}")
        res = {"single": refs["steps"][ref], "ranks": runs[0]["train"]}
        gates[name] = train_gate(res, "single", "ranks", what)
        print(f"{what}: detections match the single-process {ref} run on "
              f"both scans on every rank ({counts[:2]} detections; boxes "
              f"{DET_BOX_ATOL}, scores {DET_SCORE_ATOL}); train step at "
              f"batch 2: losses {dict(sorted(losses[0].items()))}; largest "
              f"differences " + ", ".join(
                  f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                  for k, v in gates[name].items())
              + f" (tol {TRAIN_LOSS_RTOL}, {TRAIN_GNORM_RTOL}, "
              f"{TRAIN_GRAD_L2}, {BN_UPDATE_RTOL}); rank path s "
              f"{[round(run['s'], 2) for run in runs]}; launches per rank "
              + str([{k: v for k, v in run["launches"].items() if v}
                     for run in runs]))
    runs = [r["12c"] for r in ranks]
    what = "spatial 12c, banded 2 x 2"
    state_diff = max(max_abs_diff(torch, runs[0]["state"], run["state"])
                     for run in runs[1:])
    if state_diff != 0.0 or any(run["metrics"] != runs[0]["metrics"]
                                for run in runs[1:]):
        fail(f"{what}: the replicas differ after {SP_STEPS} steps "
             f"(largest |difference| {state_diff:.3g})")
    m = runs[0]["metrics"]
    if (runs[0]["steps"] != SP_STEPS or runs[0]["updates"] != SP_STEPS
            or len(m) != SP_STEPS
            or not all(np.isfinite(list(x.values())).all() for x in m)
            or any(x["nonfinite_skips"] or x["band_overflow"] for x in m)):
        fail(f"{what}: {runs[0]['steps']} steps, {runs[0]['updates']} "
             f"updates, metrics {m}")
    print(f"{what}: train_model {SP_STEPS} steps at global batch 2, the "
          f"four replicas bitwise equal, every loss finite, no update "
          f"skipped, no band overflow; losses "
          f"{[round(x['loss'], 4) for x in m]}")
    wall = time.perf_counter() - t0
    print(f"spatial: phase 12 took {wall:.1f} s (the four rank processes "
          f"{ranks_s:.1f} s)")
    return dict(wall_s=wall, ranks_s=ranks_s, gates=gates,
                launches={name: [r[name]["launches"] for r in ranks
                                 if name in r] for name in ("12a", "12b")})


def probe_worker(argv) -> int:
    """One rank of the gloo probe: argv = op, rank, port. Runs `op` on
    CUDA tensors in a two-rank gloo group; exits 0 when the result is
    right (an exception or a wrong result fails the process)."""
    import datetime
    import torch
    import torch.distributed as tdist
    op, rank, port = argv[0], int(argv[1]), int(argv[2])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             world_size=2, rank=rank,
                             timeout=datetime.timedelta(seconds=30))
    x = torch.full((4,), float(rank + 1), device=dev)
    if op == "all_reduce":
        tdist.all_reduce(x)
        ok = x.tolist() == [3.0] * 4
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        tdist.all_gather(parts, x)
        ok = [float(p[0]) for p in parts] == [1.0, 2.0]
    else:
        if rank == 0:
            tdist.send(x, 1)
        else:
            tdist.recv(x, 0)
        ok = float(x[0]) == 1.0
    print(json.dumps({"op": op, "rank": rank, "ok": ok}), flush=True)
    tdist.destroy_process_group()
    return 0 if ok else 1


def gloo_probe() -> dict:
    """Whether gloo moves CUDA tensors in each of PROBE_OPS: one pair of
    probe_worker processes per op, each with a time limit; returns op ->
    (exit codes, the ranks' last output lines)."""
    found = {}
    for op in PROBE_OPS:
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--probe-worker",
             op, str(r), port], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=90)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n<killed at 90 s>")
        found[op] = ([p.returncode for p in procs],
                     [o.strip().splitlines()[-1] if o.strip() else ""
                      for o in outs])
        print(f"gloo probe, {op} on CUDA tensors: exit codes "
              f"{found[op][0]}; last lines {found[op][1]}")
    return found


# ------------------------------------------------------------ phase 16
P16_VIZ_IDS = "K1 K2 K3 K4 K5"
P16_PROBE_IDS = "K1"
P16_CAPS = (640, 1280, 2560)
P16_SCORE_TIE = 1e-5    # a score this near train.anchor_thr is a near-tie
P16_IOU_TIE = 1e-4      # a best IoU this near train.extra_pos_iou is one


def ring_diff(np, a, b, pairs) -> float:
    """Largest coordinate difference of the matched rings."""
    return max((float(np.abs(a[i] - b[j]).max()) for i, j in pairs),
               default=0.0)


def visualizer_gates(torch, np, device, cfg, pt: str) -> dict:
    """16a: the visualizer's scene and polylines on the card and the
    CPU."""
    from sassd_tpu_torch.tools import visualize
    reset_launches()
    pts, gt, dets = visualize.scene(cfg, None, pt, device)
    torch.cuda.synchronize()
    launches = read_launches()
    check_launched(launches, P16_VIZ_IDS, "16a visualizer")
    pts_c, gt_c, dets_c = visualize.scene(cfg, None, pt, "cpu")
    if not (np.array_equal(pts, pts_c) and np.array_equal(gt, gt_c)):
        fail("16a visualizer: the scene's points or GT boxes differ")
    if not len(dets["boxes"]) or not np.isfinite(dets["boxes"]).all():
        fail(f"16a visualizer: {len(dets['boxes'])} detections, or "
             f"non-finite ones")
    pairs = det_pairs(dets, dets_c, "16a visualizer, card vs CPU")
    lines = visualize.bev_polylines(cfg, gt, dets["boxes"])
    lines_c = visualize.bev_polylines(cfg, gt_c, dets_c["boxes"])
    if (len(lines["gt"]) != len(gt) or not all(
            np.array_equal(a, b) for a, b in zip(lines["gt"],
                                                 lines_c["gt"]))):
        fail("16a visualizer: the GT rings differ")
    ring = ring_diff(np, lines["dets"], lines_c["dets"], pairs)
    if ring > DET_BOX_ATOL:
        fail(f"16a visualizer: matched detection rings {ring:.3g} m apart")
    box = max(float(np.abs(dets["boxes"][i] - dets_c["boxes"][j]).max())
              for i, j in pairs)
    score = max(float(abs(dets["scores"][i] - dets_c["scores"][j]))
                for i, j in pairs)
    return dict(launches=launches, n_dets=len(pairs), n_gt=len(gt),
                box_diff=box, score_diff=score, ring_diff=ring)


def probe_near_ties(np, cfg, card, cpu, sample) -> dict:
    """The near-ties of one scene's card and CPU probes: scores near the
    threshold, best IoUs near extra_pos_iou, and per cap positives whose
    score lies within twice the scores' largest difference of the cut
    (the k-th passing score), in either run."""
    (_, ts, best), (_, ts_c, best_c) = card, cpu
    mask = sample["anchors_mask"]
    thr, pos_iou = cfg.train.anchor_thr, cfg.train.extra_pos_iou
    err = float(np.abs(ts - ts_c).max())
    out = dict(score_err=err, thr=int(max(
        (np.abs(x[mask] - thr) <= P16_SCORE_TIE).sum() for x in (ts, ts_c))),
        iou=int(max((np.abs(b - pos_iou) <= P16_IOU_TIE).sum()
                    for b in (best, best_c))))
    g = sample["gt_boxes"].shape[0]
    for cap in P16_CAPS:
        n = 0
        for x, b in ((ts, best), (ts_c, best_c)):
            sc = np.sort(x[(x > thr) & mask])[::-1]
            k = cap - g
            if 0 < k < len(sc):
                cut = sc[k - 1]
                idx = np.nonzero((x > thr) & mask)[0]
                near = np.abs(x[idx] - cut) <= 2 * err
                n = max(n, int((near & (b >= pos_iou)).sum()))
        out[f"cut_{cap}"] = n
    return out


def probe_gates(torch, np, device, cfg, pt: str) -> dict:
    """16b: the probe's rows on the card and the CPU."""
    from sassd_tpu_torch.data.kitti import KittiDataset
    from sassd_tpu_torch.models.detector import Detector
    from sassd_tpu_torch.tools import sweep_guided
    from sassd_tpu_torch.train import checkpoint as ckpt

    def dataset():
        # a fresh dataset draws the same augmented samples
        return KittiDataset(cfg, os.path.join(cfg.data.root, "training"),
                            os.path.join(cfg.data.root, "ImageSets",
                                         "train.txt"), train=True)

    def run(dev):
        ds = dataset()
        model = Detector(cfg)
        ckpt.restore(pt, model)          # as the tool's main
        model.to(dev)
        return sweep_guided.probe(
            cfg, model, ds, P16_CAPS, len(ds), dev,
            report=lambda r: print(f"  16b {dev.type}: {r}"))

    reset_launches()
    t = time.perf_counter()
    card = run(device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    launches = read_launches()
    check_launched(launches, P16_PROBE_IDS, "16b probe")
    t = time.perf_counter()
    cpu = run(torch.device("cpu"))
    cpu_s = time.perf_counter() - t
    ds = dataset()
    score_err, ties, diffs = 0.0, {}, 0
    for i, (a, b) in enumerate(zip(card, cpu)):
        sample = ds[i]
        near = probe_near_ties(np, cfg, a, b, sample)
        score_err = max(score_err, near.pop("score_err"))
        for k, v in near.items():
            ties[k] = ties.get(k, 0) + v
        ra, rb = a[0], b[0]
        if ra["G"] != rb["G"]:
            fail(f"16b probe, scene {i}: G {ra['G']} vs {rb['G']}")
        for key in ra:
            d = abs(ra[key] - rb[key])
            if not d:
                continue
            diffs = max(diffs, d)
            if key == "n_pass" or key.startswith("trunc_"):
                room = near["thr"]
            elif key == "n_pos":
                room = near["thr"] + near["iou"]
            else:
                room = near["thr"] + near["iou"] + near[
                    f"cut_{key.rsplit('_', 1)[1]}"]
            if d > room:
                fail(f"16b probe, scene {i}: {key} {ra[key]} (card) vs "
                     f"{rb[key]} (CPU), {room} near-tie(s) to explain it")
    if score_err > DET_SCORE_ATOL:
        fail(f"16b probe: anchor scores {score_err:.3g} apart")
    rows = [r for r, _, _ in card]
    if not sum(r["n_pass"] for r in rows):
        fail("16b probe: no candidate passed the threshold")
    spread = [float(np.ptp(ts)) for _, ts, _ in card]
    return dict(launches=launches, rows=rows, score_err=score_err,
                near_ties=ties, row_diff=diffs, card_s=card_s,
                cpu_s=cpu_s, score_spread=spread,
                summary=sweep_guided.summary(rows, P16_CAPS, card_s))


def run_phase16(torch, np, device, cfg, root: str, card: str) -> dict:
    """Phase 16 (see the module docstring). Returns its gates' numbers."""
    import dataclasses
    from sassd_tpu_torch.tools import make_synth_corpus
    from sassd_tpu_torch.train import checkpoint as ckpt
    from sassd_tpu_torch.weights import seeded_detector
    t0 = time.perf_counter()
    pt = os.path.join(root, "seeded.pt")
    ckpt.write(pt, seeded_detector(cfg, SEED, "cpu"), None, 0, 0)
    viz = visualizer_gates(torch, np, device, cfg, pt)
    print(f"16a visualizer: {viz['n_dets']} detections, {viz['n_gt']} GT "
          f"boxes; card vs CPU largest differences: boxes "
          f"{viz['box_diff']:.3g}, scores {viz['score_diff']:.3g}, "
          f"detection rings {viz['ring_diff']:.3g} m (GT rings bitwise)")
    corpus = os.path.join(root, "corpus")
    make_synth_corpus.main([corpus, "--n_train", str(CLI_CORPUS[0]),
                            "--n_val", str(CLI_CORPUS[1]),
                            "--seed", str(SEED)])
    cfg_p = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, root=corpus,
        db_info_path=os.path.join(corpus, "kitti_dbinfos_train.pkl")))
    probe = probe_gates(torch, np, device, cfg_p, pt)
    for line in probe["summary"]:
        print(f"  16b card: {line}")
    wall = time.perf_counter() - t0
    print(f"16b probe: {len(probe['rows'])} scenes; card vs CPU: anchor "
          f"scores {probe['score_err']:.3g} apart (spread per scene "
          f"{', '.join(f'{x:.3g}' for x in probe['score_spread'])}), "
          f"largest row difference {probe['row_diff']}, near-ties "
          f"{probe['near_ties']}; card {probe['card_s']:.1f} s, CPU "
          f"{probe['cpu_s']:.1f} s")
    symbols = kernel_symbols()
    for what, launches, ids in (("16a visualizer", viz["launches"],
                                 P16_VIZ_IDS),
                                ("16b probe", probe["launches"],
                                 P16_PROBE_IDS)):
        print(f"{what}: launches " + ", ".join(
            f"{k} {sum(launches[x] for x in symbols[k])}"
            for k in ids.split()))
    print(f"last entry points (phase 16), on {card}: {wall:.1f} s")
    keep = ("n_dets", "box_diff", "score_diff", "ring_diff")
    return dict(
        launches={"16a visualizer": viz["launches"],
                  "16b probe": probe["launches"]},
        summary=dict(wall_s=wall, visualizer={k: viz[k] for k in keep},
                     probe={k: probe[k] for k in (
                         "rows", "score_err", "near_ties", "row_diff",
                         "card_s", "cpu_s")}))


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "sassd_tpu_torch")):
        fail("sassd_tpu_torch is not next to chip_smoke.py; run it from a "
             "checkout of the repository")
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--cli-worker"]:
        return cli_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--sp-worker"]:
        return sp_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--probe-worker"]:
        return probe_worker(sys.argv[2:])
    sys.path.insert(0, HERE)
    import dataclasses
    import numpy as np
    import torch

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()
    card = smi[0] if smi else "<nvidia-smi printed nothing>"
    print(f"device: {name} ({torch.cuda.device_count()} visible); "
          f"nvidia-smi: {card}")
    from sassd_tpu_torch.config import car_config
    from sassd_tpu_torch.data import kitti, synthetic
    from sassd_tpu_torch.ops import build, cuda, native, riou_kernel
    from sassd_tpu_torch.ops import sparse as sp
    from sassd_tpu_torch.weights import seeded_detector
    print(run([cuda.nvcc(), "--version"]).splitlines()[-1:])

    t = time.perf_counter()
    native.load()
    host_s = time.perf_counter() - t
    t = time.perf_counter()
    cuda.load()
    kern_s = time.perf_counter() - t
    print(f"build: host library {host_s:.1f} s, CUDA kernels {kern_s:.1f} s "
          f"({len(cuda.SOURCES)} nvcc in parallel + link)")
    for line in build.BUILD_LOG.get("sassd_kernels", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    cfg = car_config()
    if "--data-parallel-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as root:
            run_data_parallel(torch, np, device, cfg, root)
        print(card)
        return 0
    if "--cli-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as root:
            run_cli(torch, np, device, root)
        print(card)
        return 0
    if "--gloo-probe" in sys.argv[1:]:
        gloo_probe()
        print(card)
        return 0
    if "--spatial-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as root:
            run_spatial(torch, np, device, root)
        print(card)
        return 0
    if "--phase14-only" in sys.argv[1:]:
        p14 = run_phase14(torch, np, device, cfg,
                          seeded_detector(cfg, SEED, device))
        print(json.dumps({"phase14_only": p14["rows"]}))
        print(card)
        return 0
    if "--phase15-only" in sys.argv[1:]:
        p15 = run_phase15(torch, np, device, cfg,
                          seeded_detector(cfg, SEED, device))
        print(json.dumps({"phase15_only": p15["rows"]}))
        print(card)
        return 0
    if "--phase16-only" in sys.argv[1:]:
        with tempfile.TemporaryDirectory() as root:
            p16 = run_phase16(torch, np, device, cfg, root, card)
        print(json.dumps({"phase16_only": p16["summary"]}))
        print(card)
        return 0
    cfg_dev = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, host_plans=False))
    anchors, anchors_bv = kitti.build_anchors(cfg)
    rng = np.random.default_rng(SEED)
    scenes = [synthetic.make_scene(rng, n_cars=(6, 12), n_ground=18000)
              for _ in range(N_SCANS)]
    scans = [p for p, _, _ in scenes]
    t = time.perf_counter()
    samples = [kitti.prepare_scan(cfg, p, anchors_bv) for p in scans]
    host_ms = (time.perf_counter() - t) * 1e3 / N_SCANS
    t = time.perf_counter()
    samples_dev = [kitti.prepare_scan(cfg_dev, p, anchors_bv) for p in scans]
    host_dev_ms = (time.perf_counter() - t) * 1e3 / N_SCANS
    if any(k.startswith("plan_") for k in samples_dev[0]):
        fail("prepare_scan built host plans with host_plans=False")
    n_vox = [int((s["coords"][:, 0] >= 0).sum()) for s in samples]
    print(f"host leg ms/scan: {host_ms:.1f} with the C++ rulebook, "
          f"{host_dev_ms:.1f} without (voxelize + mask); active voxels "
          f"{n_vox}")

    t = time.perf_counter()
    train_samples = [kitti.prepare_scan(cfg, p, anchors_bv, train=True)
                     for p in scans[:2]]
    train_host_ms = (time.perf_counter() - t) * 1e3 / 2
    print(f"host leg ms/scan with the C++ train rulebook (strideT, aux): "
          f"{train_host_ms:.1f}")
    g = cfg.caps.max_gt
    gts = (np.zeros((2, g, 7), np.float32), np.zeros((2, g), bool))
    for i, (_, bx, _) in enumerate(scenes[:2]):
        gts[0][i, :len(bx)] = bx[:g]
        gts[1][i, :len(bx)] = True

    if "--bf16-only" in sys.argv[1:]:
        # phase 13 alone, on phase 7's train step and phase 9's scans
        rows = check_bf16_kernels(torch, np, device, cfg, samples,
                                  train_samples)
        with tempfile.TemporaryDirectory() as root:
            training = run_training(torch, np, device, cfg, root)
            lr = long_range_inputs(np, root, timing=False)
            run_bf16(torch, np, device, cfg, root, samples, training[5],
                     dict(cfg_b=lr["cfg_b"], cfg_r=lr["cfg_r"],
                          samples=lr["samples"], anchors=lr["ds"].anchors))
        print(json.dumps({"bf16_only": rows}))
        print(card)
        return 0
    rows = check_kernels(torch, np, device)
    rows += check_sparse_kernels(torch, np, device, cfg, samples)
    rows += check_train_kernels(torch, np, device, cfg, train_samples, gts)
    rows += check_train_plan_kernels(torch, np, device, cfg, train_samples)
    frustum = synthetic.make_scene(np.random.default_rng(SEED + 2),
                                   n_cars=(6, 12), n_ground=18000,
                                   frustum=True)[0]
    rows += check_serving_kernels(torch, np, device, cfg, scans + [frustum],
                                  anchors_bv)
    model_dev = seeded_detector(cfg, SEED, device)
    k1_row = next(r for r in rows if r["name"] == "K1 rotate_overlap")
    nms_boxes_in, k3_inputs = serving_inputs(torch, np, device, cfg,
                                             model_dev)
    nms = check_nms_input(torch, riou_kernel, nms_boxes_in)
    k1_row["max_abs_err"] = max(k1_row["max_abs_err"], nms.pop("max_abs_err"))
    k1_row.update(nms)
    rows.append(check_k3_serving(torch, k3_inputs))
    if "--kernels-only" in sys.argv[1:]:
        # phases 1-3 and phase 9's kernel checks alone: the kernel rows of
        # this checkout under their own key (no launch counts, no result
        # line), for comparing two checkouts in one call
        with tempfile.TemporaryDirectory() as root:
            lr = long_range_inputs(np, root)
            rows += check_banded_kernels(torch, np, device, lr["cfg_b"],
                                         lr["spec"], lr["batch"],
                                         lr["t_batch"])
        rows += check_bf16_kernels(torch, np, device, cfg, samples,
                                   train_samples)
        for r in rows:
            print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms")
        print(json.dumps({"kernels_only": rows}))
        print(card)
        return 0

    model = seeded_detector(cfg, SEED, "cpu")               # CPU copy
    host = run_phase(torch, np, device, cfg, model_dev, anchors, samples,
                     "host plans")
    dev = run_phase(torch, np, device, cfg_dev, model_dev, anchors,
                    samples_dev, "device plans")
    with tempfile.TemporaryDirectory() as root:
        serving, peaks = peak_phases(torch, np, device, cfg, model_dev, model,
                                     root, "6")
    with tempfile.TemporaryDirectory() as root:
        training = run_training(torch, np, device, cfg, root)
    with tempfile.TemporaryDirectory() as root:
        (multi_runs, multi_step), peak = peak_phases(
            torch, np, device, cfg, model_dev, model, root, "8", training[2])
    peaks.update(peak)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        (lr_rows, lr_runs, lr_step, lr_ms, lr_train_ms, lr_refs), peak = (
            peak_phases(torch, np, device, cfg, model_dev, model, root, "9"))
    peaks.update(peak)
    print(f"long range: phase 9 took {time.perf_counter() - t:.1f} s")
    rows += lr_rows
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms")
    # K7' and K11' are K7 and K11 called with a limit and with origins:
    # the banded phases are the only callers that pass them
    symbols = kernel_symbols()
    for what, launches, ids in (("host plans", host[4], "K1 K2 K3 K4 K5"),
                                ("device plans", dev[4],
                                 "K1 K2 K3 K4 K5 K6 K7"),
                                ("serving", serving[0],
                                 "K1 K2 K3 K4 K5 K6 K7 K8 K9"),
                                ("training", training[0],
                                 "K1 K3 K3b K4 K5 K5b K10 K11 K12"),
                                ("three-class training, ring",
                                 multi_runs["ring"], "K1 K3 K3b K4 K5 K5b "
                                 "K6 K7 K10 K11 K12 K13 K14"),
                                ("three-class training, exact",
                                 multi_runs["exact"], "K1 K3 K3b K4 K5 K5b "
                                 "K6 K7 K10 K12 K13 K15"),
                                ("long range, banded inference",
                                 lr_runs["banded"],
                                 "K1 K2 K3 K4 K5 K6 K16 K7'"),
                                ("long range, replicated inference",
                                 lr_runs["replicated"],
                                 "K1 K2 K3 K4 K5 K6 K7"),
                                ("long range, banded training",
                                 lr_runs["training"], "K1 K3 K3b K4 K5 K5b "
                                 "K6 K10 K12 K13 K14 K16 K7' K11'")):
        check_launched(launches, ids, what)
    for what, launches, kind in (
            ("serving, batch 1", serving[4], "inference"),
            ("three-class training, ring, batch 1", multi_step["ring"],
             "training"),
            ("three-class training, exact, batch 1", multi_step["exact"],
             "training"),
            ("long range, banded training, batch 2", lr_step, "training")):
        check_counts(launches, RULEBOOK_CALLS[kind], what)
    exact = multi_runs["exact"]
    if exact["sassd_ring_interp_bwd"] == 0:
        fail("three-class training, exact: K11's backward was not launched")
    if (any(exact[s] for s in sp.KERNEL_SYMBOLS["K14"])
            or exact["sassd_ring_interp_fwd"]):
        fail("three-class training, exact: the ring aux path ran")
    if lr_runs["replicated"]["sassd_band_partition"]:
        fail("long range, replicated inference: the band partition ran")
    for i in range(N_SCANS):
        match_detections(dev[0][i], host[0][i],
                         f"scan {i}: device plans vs host plans")
    print(f"device plans agree with host plans on all {N_SCANS} scans")
    check_cpu(np, cfg, model, anchors, samples[0], host[0][0], "host plans")
    check_cpu(np, cfg_dev, model, anchors, samples_dev[0], dev[0][0],
              "device plans")
    with tempfile.TemporaryDirectory() as root:
        data_parallel = run_data_parallel(torch, np, device, cfg, root)
    with tempfile.TemporaryDirectory() as root:
        cli = run_cli(torch, np, device, root)
    with tempfile.TemporaryDirectory() as root:
        spatial = run_spatial(torch, np, device, root, lr_refs)
    t = time.perf_counter()
    rows += check_bf16_kernels(torch, np, device, cfg, samples,
                               train_samples)
    with tempfile.TemporaryDirectory() as root:
        bf16_launches, bf16_step, bf16 = run_bf16(
            torch, np, device, cfg, root, samples, training[5],
            lr_refs["inputs"])
    print(f"bf16: phase 13 took {time.perf_counter() - t:.1f} s")
    p14 = run_phase14(torch, np, device, cfg, model_dev, training[5])
    rows += p14["rows"]
    persistent = p14["persistent"]
    p15 = run_phase15(torch, np, device, cfg, model_dev, training[5],
                      lr_refs["inputs"])
    rows += p15["rows"]
    with tempfile.TemporaryDirectory() as root:
        p16 = run_phase16(torch, np, device, cfg, root, card)

    for what, (_, _, ms1, ms2, _) in (("host plans", host),
                                      ("device plans", dev)):
        print(f"car config, {what}, on {name} [{card}]: batch 1 "
              f"{', '.join(f'{m:.2f}' for m in ms1)} ms/scan; batch 2 "
              f"{ms2:.2f} ms ({ms2 / 2:.2f} ms/scan)")
    _, ms1, ms2, serve_host_ms, _ = serving
    print(f"car config, serving (raw points uploaded in the step), on "
          f"{name} [{card}]: batch 1 {', '.join(f'{m:.2f}' for m in ms1)} "
          f"ms/scan; batch 2 {', '.join(f'{m:.2f}' for m in ms2)} ms/scan; "
          f"host leg (prepare_points) {serve_host_ms:.2f} ms/scan")
    _, _, train_ms, train_leg_ms, _, _ = training
    print(f"car config, training at batch 2, on {name} [{card}]: "
          f"{', '.join(f'{m:.2f}' for m in train_ms)} ms/step (host clock, "
          f"synchronised, loader excluded); host leg (read + voxelize + "
          f"mask + C++ train rulebook) {train_leg_ms:.2f} ms/step")
    print(f"car config, data-parallel training (phase 10), on {name} "
          f"[{card}]: {data_parallel['wall_s']:.1f} s, the two gloo ranks "
          f"{data_parallel['ranks_s']:.1f} s")
    print(f"CLIs (phase 11), on {name} [{card}]: {cli['wall_s']:.1f} s; "
          f"processes (s) " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in cli["procs"].items()))
    print(f"spatial strategies over gloo ranks (phase 12), on {name} "
          f"[{card}]: {spatial['wall_s']:.1f} s, the four rank processes "
          f"{spatial['ranks_s']:.1f} s")
    for what in ("banded", "replicated"):
        print(f"long range, {what}, timing scan at batch 1, on {name} "
              f"[{card}]: {', '.join(f'{m:.2f}' for m in lr_ms[what])} "
              f"ms/scan; train step at batch 2 (comparison scans): "
              f"{', '.join(f'{m:.2f}' for m in lr_train_ms[what])} ms/step "
              f"(host clock, synchronised, loader excluded)")
    for what, key, unit in (("serving at batch 1 (raw points uploaded in "
                             "the step)", "serve_ms", "ms/scan"),
                            ("training at batch 2 (host plans, loader "
                             "excluded)", "train_ms", "ms/step")):
        print(f"car config, {what}, float32 and bfloat16 in turns, on "
              f"{name} [{card}]: " + "; ".join(
                  f"{dt} {', '.join(f'{m:.2f}' for m in v)}"
                  for dt, v in bf16[key].items())
              + f" {unit} (host clock, synchronised)")
    print(f"car config, serving at batch 1, per-scan and persistent plans "
          f"in turns, on {name} [{card}]: " + "; ".join(
              f"{mode} {', '.join(f'{m:.2f}' for m in v)}"
              for mode, v in persistent["ms"].items())
          + " ms/scan (host clock, synchronised, upload inside); rulebook "
          "stage kernels / span by the profiler: " + "; ".join(
              f"{mode} " + ("not measured" if v is None else
                            f"{v[0]:.4f} / {v[1]:.4f}")
              for mode, v in persistent["rulebook_ms"].items())
          + " ms/scan")
    sv = p15["serving"]
    print(f"car config, serving at batch 1, the rulebook stage's kernels a "
          f"scan by the profiler, dense and sorted plan lookups in turns, on "
          f"{name} [{card}]: " + "; ".join(
              f"{mode} " + ", ".join("not measured" if r["ms"] is None
                                     else f"{r['ms']:.4f}" for r in v)
              for mode, v in sv["rulebook"].items()) + " ms")
    for what, turns in (("car training, batch 2",
                         p15["train_rulebook"]["car"]),
                        ("long range banded training, 8 band rows",
                         p15["train_rulebook"]["banded"])):
        print(f"{what}, the rulebook stage's kernels (train=True, aux) by "
              f"the profiler, dense and sorted in turns, on {name} [{card}]: "
              + "; ".join(f"{mode} " + ", ".join(
                  "not measured" if r["ms"] is None else f"{r['ms']:.4f}"
                  for r in v) for mode, v in turns.items()) + " ms")
    for what, peak in (("15b serving, 4 scans at batch 1 and 2",
                        sv["peaks"]),
                       ("15c car training, batch 2", p15["train"]["peaks"]),
                       ("15d long range banded training, batch 2",
                        p15["banded"]["peaks"])):
        print(f"peak device memory, {what}, on {name} [{card}]: dense "
              f"{peak['dense']['peak_mib']:.1f} MiB, sorted "
              f"{peak['sorted']['peak_mib']:.1f} MiB (allocated at the "
              f"start {peak['dense']['start_mib']:.1f} / "
              f"{peak['sorted']['start_mib']:.1f})")
    print(f"peak device memory by phase, on {name} [{card}]: " + "; ".join(
        f"phase {k} {v['peak_mib']:.1f} MiB (allocated at its start "
        f"{v['start_mib']:.1f})" for k, v in peaks.items()))
    banded_phases = (("long range, banded inference", lr_runs["banded"]),
                     ("long range, banded training", lr_runs["training"]),
                     ("bf16 long range, banded inference",
                      bf16_launches["long range, banded"]),
                     ("sorted long range banded training step",
                      p15["banded"]["launches"]["sorted"]))
    all_phases = (("host plans", host[4]), ("device plans", dev[4]),
                  ("serving", serving[0]), ("training", training[0]),
                  ("three-class training, ring", multi_runs["ring"]),
                  ("three-class training, exact", multi_runs["exact"]),
                  ("long range, replicated inference",
                   lr_runs["replicated"]),
                  ("bf16 host plans", bf16_launches["host plans"]),
                  ("bf16 serving", bf16_launches["serving"]),
                  ("bf16 training", bf16_launches["training"]),
                  ("persistent serving", persistent["launches"]),
                  ("RotateIou2d training step",
                   p14["similarity"]["launches"]),
                  ("DistanceSimilarity forward",
                   p14["similarity"]["distance_launches"]),
                  ("sorted serving", sv["launches"]),
                  ("sorted car training step",
                   p15["train"]["launches"]["sorted"]),
                  *p16["launches"].items()
                  ) + banded_phases
    banded_step = (("long range banded training, batch 2", lr_step),
                   ("sorted long range banded training, batch 2 (two "
                    "backward passes)", p15["banded"]["launches"]["sorted"]))
    all_steps = (("serving, batch 1", serving[4]),
                 ("training, batch 2", training[1]),
                 ("three-class training, ring, batch 1", multi_step["ring"]),
                 ("three-class training, exact, batch 1",
                  multi_step["exact"]),
                 ("bf16 serving, batch 1", bf16_step["serving"]),
                 ("bf16 training, batch 2", bf16_step["training"]),
                 ("persistent serving, batch 1", persistent["per_step"]),
                 ("RotateIou2d training, batch 2",
                  p14["similarity"]["launches"]),
                 ("sorted serving, batch 1", sv["per_step"]),
                 ("sorted car training, batch 2 (two backward passes)",
                  p15["train"]["launches"]["sorted"])
                 ) + banded_step
    for r in rows:
        kid = r["name"].split()[0]
        primed = kid.endswith("'")
        by_phase = {what: sum(launches[s] for s in symbols[kid])
                    for what, launches in (banded_phases if primed
                                           else all_phases)}
        r["launches"] = sum(by_phase.values())
        r["launches_by_phase"] = by_phase
        r["launches_per_step"] = {
            what: sum(launches[s] for s in symbols[kid])
            for what, launches in (banded_step if primed else all_steps)}
        # phase 12a: the path over 4 banded ranks, each rank's count
        r["launches_per_rank"] = {
            "phase 12a, banded over 4 ranks": [
                sum(launches[s] for s in symbols[kid])
                for launches in spatial["launches"]["12a"]]}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
