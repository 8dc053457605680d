"""Drive the PyTorch port (``richsem_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each printed as it completes:

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every hand-written kernel from
   ``richsem_tpu_torch/csrc`` (twelve sources, one nvcc per source, all at
   once, sm_90a) with its register report (and any ptxas note that it
   serialised ``wgmma`` products); K1, K1-bwd, K2, K2-bwd, K3, K3-bwd, K4 (the
   auction) and ``adamw.cu`` (K5 and K6, the optimizer) must spill nothing,
   and so must the redesigned probe kernels (``mxu_kernel``,
   ``vpu_bf16_kernel``, ``repeat_f32_kernel`` and ``repeat_bf16_kernel``,
   ``cell_kernel`` and its ``cell_reduce_kernel``, ``fma_kernel``), checked
   by name since their sources hold other kernels.
2. K1 (deformable attention) against its plain PyTorch version at the
   production encoder shapes (clamped offsets) and decoder shapes (1,100 box
   queries, unclamped), in bf16 and f32: max abs error and both times; one
   profiled call at the decoder (device time, since the CUDA-event time of so
   short a call is the host's).
3. K1-bwd against the autograd gradient of the plain version, same shapes,
   a third case at the encoder's shapes with ``bench.py``'s valid extent
   (800 x 1224 in 896 x 1344: valid ratios below 1 that differ by level),
   and ``msda_edge_cases``: F3's 256 x 384 canvas with a 200 x 300 valid
   extent and every offset on the clamp's edge, and 1,100 unclamped decoder
   queries piled onto four value rows a level; in every case and dtype
   d_value bit for bit equal to the plain fixed-point sum
   (``ms_deform_attn_dvalue_plain``, on the card), and at the decoder also
   with an infinity in g (NaN rows, the kernel's bits); twenty launches at
   the encoder's and the decoder's shapes, bf16 and f32, with d_value, d_loc
   and d_aw bit for bit (``repeat_check``); the device time of a call and of
   each of its parts (the tap kernel, the d_value pass's count, shift,
   scatter and convert kernels and the memset of its counts; five profiled
   calls) at the encoder, the decoder and the piled case.
4. K2 (fused encoder tail) against its plain version at N = 49,980 in bf16:
   the output, and the elements of bf16(x) and of the relu masks that differ
   from the plain version's (at most 1e-5 of the masks may flip); the same
   output from the entry point that also writes those, bit for bit; the time
   beside ``gemm_ms``, two ``torch.matmul`` calls of K2's product shapes
   (informational: another function), and one profiled call.
5. K2-bwd against the plain version's autograd gradient: all ten gradients at
   N = 49,980 and at ragged N = 1 and 200, two calls at N = 49,980 bit for
   bit, and one profiled call (device time of each of its kernels).
6. The flagship eval step (``configs/richsem/richsem_4scale_lvis.py``, bf16,
   random weights from a seeded generator, a 1204 x 1024 text bank) on 3
   batches of 2 images at 896 x 1344, each a replay of the step's CUDA graph
   (``train/engine.py:EvalStep``): outputs checked, K1/K2 launches counted
   (12 and 6 per forward), ms/batch, img/s and peak memory. The graph's
   checks: the replay against the eager body (``eval_forward``) on the same
   batch and weights, bit for bit, at two keys (bs2 896 x 1344 and
   1344 x 896), with each key's warm-up and capture ms; one replay under
   ``torch.cuda.set_sync_debug_mode("error")``; the shared pool's memory; the
   guarded profile of a replay (busy ms, operations, idle share). Then one
   batch against the same model with the plain versions in place of the
   kernels.
   Then the CLIP-align head's bf16 tensor-core product (ROADMAP F-P7) against
   the plain f32 product on the operands of its three sites (the encoder
   output, the decoder stack, the selected queries), within 1e-5 of the
   largest |logit|, and the forward's top-900 selection and top-300 result
   against those with the plain head (at least 0.999 shared); last, one
   profiled eager batch (the body: a replay runs the head it captured) with
   the plain head and one with the tensor-core head, each guarded by the
   launch counts (``bench.py:guarded_profile``), with their busy time and
   GEMMs: the f32 CUDA-core GEMMs must fall by the head's three products.
7. The training step of ``configs/richsem/dino_4scale_lvis.py`` (bf16, bs2
   at 896 x 1344, the synthetic batch of ``bench.py``: 300 GT slots, 16
   valid): one warm-up step (eager; it captures the step's CUDA graph,
   ``train/engine.py:TrainStep``: warm-up + capture ms and the pool's GB)
   and 5 steps, each a replay, loss and grad norm per step, launches per
   step (K1 12, K1-bwd 12, K2 6, K2-bwd 6, K3 0, K3-bwd 0, K4 7, K5 1, K6 1:
   a replay counts the deltas its capture recorded), auction rounds read from K4's
   device counter, ms/step, img/s, peak memory allocated and reserved; one
   more replay under ``torch.cuda.set_sync_debug_mode("error")`` (a replay
   may read nothing on the host); the replay against the eager body from one
   state (``graph_vs_eager``: the state copied aside, one eager step and a
   replay on one batch and draws, the state put back before each; every
   metric, ``grad_norm`` included, and the parameters, AdamW moments and EMA
   after the update bit for bit, ROADMAP F-P6 repaired: K1-bwd and K3-bwd
   sum d_value in an order-free fixed-point pass, the body runs under
   cuDNN's deterministic mode and the mask heads' resizes take fixed-order
   gradients); two runs of five
   replays from one state and seed, their losses and state bit for bit
   (``two_runs``); then the
   gradients of a few named leaves against those of the same step with the
   plain versions in place of every kernel (the plain auction too), and one
   profiled replay with its operations, the hand-written kernels it shows
   and K4's device ms.
8. K3 (the separable decoder sampler) against its plain dense version at the
   decoder's shapes (1,100 queries) and at odd row counts (B1, Q 37, M 1 and
   3), bf16 and f32; run right after phase 3, on its inputs; five profiled
   calls (the mean device time, ``device_ms``).
9. K3-bwd against the plain version's explicit backward, same shapes and
   phase 3's ``msda_edge_cases``, with d_value bit for bit equal to the plain
   fixed-point sum (``ms_deform_attn_sep_dvalue_plain``) in every case and
   dtype, and with an infinity in g at the decoder; twenty launches at the
   decoder's shapes, bf16 and f32, bit for bit; the device time of a call
   and of each of its parts (five profiled calls) at the decoder and the
   piled case.
10. The flagship train step (``richsem_4scale_lvis.py``: the CLIP-text
    classifier, a random-weight bf16 CLIP-RN50 teacher and a random
    1204 x 1024 text bank as ``bench.py:114-126`` builds them, distillation
    at the first 100 valid GT boxes): the teacher's targets timed alone, then
    as phase 7 with ``loss_distill`` and ``loss_distill_dn`` per step, the
    launches checked (K1 12, K1-bwd 12, K2 6, K2-bwd 6, K3 0, K3-bwd 0, K4 7,
    K5 1, K6 1;
    the warm-up step's seven cost matrices kept for phase 15), the CLIP heads
    among the compared gradients, a profiled step, and the loss's
    forward and backward (one set of weights, batch and draws, no update)
    profiled with the plain head and with the tensor-core head, as in phase 6.
11. The same step with ``dec_msda_impl="sep_pallas"``: 2 steps, launches
    checked (6 of each of the six model kernels, K4 7, K5 1, K6 1), the
    graph's checks
    of phase 7, the loss, the gradients against the plain versions, and the
    profiles of phase 10.
12. The calibration probes (``richsem_tpu_torch/tools``, the ports of the
    Pallas probes in ``tools/``): each module's ``main()`` at the JAX defaults
    with every probe kernel's launches counted and checked, then each probe
    kernel against its plain version (exact, or the stated tolerance) with
    its device time (the mean of five profiled calls) and CUDA-event time,
    the plain version's time, the device and event times of the one PyTorch
    call that computes the same function where there is one (``x * 2``,
    ``x.repeat``, ``x + x`` and ``x * 3`` for chain-1 and chain-2, a
    broadcast product for fma-1, ``torch.einsum`` for fma-P), the bound (its
    CUDA-core operations at the issue rate, each rounded on its own, with the
    same count at the published peaks beside it where that differs) and the
    share by device time.
    ``run_cell`` also gets a check that two calls agree bit for bit (its
    pass ranges' partials are summed in a fixed order), with the device time
    of both its kernels. ``run_mxu`` also gets ``gemm_ms``, the device
    time of one bf16 ``torch.matmul`` of the same tensor-core work on
    operands concatenated outside the call (a yardstick, another function),
    a check that two calls agree bit for bit, and an exact case that isolates
    the packed add (``b = I``, 96 rows, s = 32). Last, the probe kernels in
    the round's order by device time: those slower than their PyTorch call
    by factor, then the rest by launches x (device ms - bound).
13. The trainer through its entry point (``richsem_tpu_torch/train/main.py``):
    a synthetic LVIS-v1 directory (1203 categories, 16 train and 4 val PNGs of
    480-640 x 640-960 px, written with zlib), ``train_loop`` on
    ``dino_4scale_lvis.py`` at full width, bf16, bs2 for one epoch (its steps,
    one eval, a checkpoint; launches checked: 12/12/6/6/7/1/1 a step, K1 12 and
    K2 6 an eval forward, a replay a batch and a warm-up a graph); the train
    graphs it captured (one a canvas bucket: their number, each one's
    warm-up + capture ms and the pool), and with them live one more step, the
    checkpoint restored into that state in place and compared bit for bit,
    and a replay against the eager body as in phase 7; again with
    ``epochs=2`` (auto-resume, one more epoch),
    the checkpoint restored into a fresh state and compared bit for bit, and
    ``python -m richsem_tpu_torch.train.main --eval`` in a subprocess; finite
    loss and AP in [0, 1] checked; ms/step, the loader's wait, eval ms/batch,
    checkpoint save and restore s and peak memory printed.
14. The port's benches, in this process: ``richsem_tpu_torch/bench.py`` (the
    flagship train step: 3 warm-up and 20 timed steps, one profiled step
    guarded by the launch counts; then again with ``BENCH_FUSED_OPT=1``, AdamW
    in ``fused_adamw``'s order), ``tools/bench_eval.py`` at its single point
    (5 and 30 batches, one guarded profiled batch) and
    ``tools/bench_input_pipeline.py`` at 100 images (the JAX tool's corpus as
    JPEG at quality 90, decoded by the port's host codec,
    ``csrc/jpeg_host.c``), with the train bench's img/s as its chip rate,
    printing img/s, ``ratio_to_chip`` and the codec's decode ms an image on
    one host thread. Each JSON line is printed; the value, the median,
    min and max, the busy ms, the idle share in [0, 1], the card and the
    launches a step (K1 12, K1-bwd 12, K2 6, K2-bwd 6, K4 7, K5 1, K6 1;
    eval K1 12, K2 6) are checked, and the train line's auction rounds and K4 device ms and
    both lines' graph, capture ms and pool are present (each step a replay).
15. K4, the auction (run after phase 11, on phase 10's matrices), against the
    plain ``_auction`` on the same CUDA tensors, exact (``torch.equal`` on the
    assignment, each problem's rounds against the plain loop on that problem
    alone): the seven matchings of one flagship step, correlated rows (one
    random row plus noise) at P 300 with 16 valid and O 900, random costs at
    P 300 with 16 and with 300 valid and O 900, the price-war tied rows of
    ``tests/test_lap.py``, a cap of 3 that leaves the greedy fallback
    collisions, a problem with no valid person, and P 20 with 17 valid at
    O 30 (rows of 120 bytes, no float4); each with its device time a round;
    then K4's device time (five profiled calls) and CUDA-event time beside
    the plain loop's host and device time on the first flagship matching,
    its rounds, bids, time a round and bound.
16. K5 and K6, the optimizer's global norm and AdamW update
    (``csrc/adamw.cu``, run after phase 15), on the flagship model's leaves
    at their real shapes (338 trainable, 224 frozen with the FrozenBN
    buffers, one trainable leaf without a gradient), with gradients from a
    seeded generator: in both orders (the optax chain and ``fused_adamw``),
    three steps from one state, the clip binding, binding and not binding,
    against the plain versions (parameters, m and v to rtol 1e-6 and atol
    1e-7, the norms within one f32 step, the launches 3 and 3); K5 twice and
    K6 twice from one state, bit for bit; each kernel's device time (five
    profiled calls) and CUDA-event time beside the plain version's, its bound
    by bytes at 3.35 TB/s and the share; for K6 the CUDA-event time of
    ``torch._fused_adamw_``, one call a lr group (a yardstick: it rounds its
    decoupled decay otherwise).
17. Data parallelism (``richsem_tpu_torch/parallel/dist.py``, run last):
    ``train_loop`` on phase 13's config and a synthetic LVIS directory for
    one epoch, twice without a process group and once with the launcher's
    environment set (``RANK`` 0, ``WORLD_SIZE`` 1), as the one rank of an
    NCCL group on ``cuda:0``: the backend and device; the steps and launches
    of phase 13's first run (12/12/6/6/7/1/1 a step) and one gradient
    collective a step; the parameters after the epoch within twice the
    largest difference and twice the l2 distance of the two single-process
    runs, each at least one rounding step of the largest parameter (the runs
    repeat bit for bit since F-P6's repair); the
    epoch's eval, gathered to rank 0, equal to a single-process ``evaluate``
    of the same parameters; guarded profiles of three replays, each holding
    exactly one NCCL kernel (in a one-rank group NCCL's AVG is its one-rank
    reduce kernel), in turns with three of a single-process run's on the same
    batch: the busy ms of each (and phase 10's), the NCCL kernel's device ms,
    the averaged buffer's bytes and the operations the collective adds; and
    ``--eval`` under the group writing ``eval.json`` with the epoch's AP;
    and in the group a CUDA graph of one 48 MB in-place all-reduce with SUM
    and with AVG, each replay profiled (the NCCL kernels and their device
    ms). The group is destroyed at the end.

18. The flagship with the Swin-L backbone (``swin_L_384_22k``: embed 192,
    depths (2, 2, 18, 2), window 12; run after phase 14), bf16, bs2 at
    896 x 1344, random weights from a seed: the eval graph (3 replays, the
    replay against the eager body bit for bit, K1 and K2 launches, ms/batch,
    img/s, peak memory), then the train graph as phase 10 with the teacher,
    the text bank and the distillation (``run_train``: one warm-up and
    capture, 5 replays with the launches checked, K6 2 a step from the
    optimizer's tables, the loss and ``grad_norm`` finite; a replay under
    ``set_sync_debug_mode("error")``; the replay against one eager step
    from one state, batch and draws, ``graph_vs_eager``: every metric and
    the state after the update bit for bit; gradient cosines of backbone
    leaves against the plain versions; a profiled replay and its f32
    CUDA-core GEMMs beside phase 10's, ROADMAP F-P10). Each part's seconds.
19. ConvNeXt-XL (``convnext_xlarge_22k``) and FocalNet-L
    (``focalnet_L_384_22k``) in the flagship, bf16, bs2 at 896 x 1344,
    eager: one eval batch (finite, K1 12 and K2 6, peak memory) and one
    train step (finite loss and ``grad_norm``, the launches, peak memory).
20. The memory knobs on the R50 flagship at bs2 (one eager step each, one
    state, batch and draws): the knob-free step twice, then
    ``use_checkpoint``, ``enc_selective_remat`` and ``backbone_remat``
    alone, each step's metrics (``grad_norm`` too) and every gradient equal
    to the first knob-free step's bit for bit and its peak memory below it,
    K1's and K2's forward launches 24/12, 12/12 and 12/6
    (``KNOB_LAUNCHES``); the same steps with the plain versions and PyTorch's
    deterministic algorithms, each again equal to its first step bit for bit
    (each step's gradients against the first's, leaf by leaf, printed in
    both settings);
    then the train bench at ``BENCH_BATCH`` 4 and 8 (the root bench's remat
    knobs on: K2 12 a step), its JSON line, img/s, busy ms and peak memory.
    First, ROADMAP F-P14 (``fused_tail_route_check``): an encoder layer at
    the production width with ``enc_fused_tail=False`` launches K2 0 times
    and gives the modules' composition bit for bit, with the knob on K2
    once and within phase 4's bound of it; K2 in f32 refuses, naming
    ``enc_fused_tail=False``.
21. Variant A, "semantic" (the flagship with ``share_vl_proj``,
    ``enc_cls_agn``, ``two_stage_cls``, ``distill_aux_layers``,
    ``use_clip_visual_query``, ``check_pos_dn``, ``OptMatcher`` and NMS at
    0.7; the random bf16 RN50 teacher; bs2 at 896 x 1344): the eval graph
    with the teacher's spatial pass (3 replays, each against its eager body
    bit for bit; K1 12, K2 6 and K7 1 a batch; ms/batch, img/s, peak
    memory); K7 against its plain version on the eval's own boxes and scores
    and on ``k7_cases`` (ties, IoUs exactly at the threshold, a suppression
    chain across a word boundary, N 1,024, 1,000, 33 and 1), keep masks
    equal; on the eval's boxes and on N 1,024 its device and CUDA-event time
    and its rank, IoU, sweep and scatter passes apart (stamps), beside the
    plain loop's time, its bound and the sweep's latency floor (ceil(N / 32)
    block steps, one timed alone on one warp); then phase 18's ``run_train``
    (K4 0 a step: every matched set goes through simOTA).
22. Variant B, "groups and tail" (``dn_number`` 5: the group-count branch,
    a pad of 4 x 5 x 100 = 2,000 DN slots with 100 GT slots, 16 valid;
    gelu; dropout 0.1; ``HungarianMatcherCPU``): the step on the card
    refuses a graph, two eager steps (finite, K1 12 and K1-bwd 12, K2 and K4
    0 a step, peak memory), SciPy's assignment of the first matching
    against K4's on the same cost (equal total cost within the auction's
    n_valid * eps); then dropout in a graph at a cut width (one encoder
    and one decoder layer, 256 x 384): the replay against one eager step,
    and two replays a step apart drawing different masks.
23. The ViT-B/32 recipe (``richsem_4scale_lvis.py`` with ``clip_model=
    "ViT-B/32"``; run after phase 22), bf16, bs2, random weights from a
    seed, the random bf16 ViT-B/32 teacher and a 1204 x 512 text bank from
    its text tower over seeded token ids (the BPE merges are not in the
    repository): (a) serving with ``use_clip_visual_query`` at 896 x 1344,
    the teacher's spatial pass (28 x 42 patches and the class token, 12
    layers of width 768) in the eval graph: 3 replays, each against its
    eager body bit for bit, K1 12 and K2 6 a batch, ms/batch, img/s, peak
    memory; (b) one eager eval batch at 1344 x 2048, whose 42 x 64 teacher
    map (2,688 cells) takes RoIAlign's gather path through ``auto``: its
    crops against the matmul path's on the same map and boxes, TF32 off,
    within 1e-5 of the largest magnitude; (c) training with
    ``use_visual_distill=False`` (the bank feeds the classifier): the train
    graph, 5 replays, finite losses, K1 12, K1-bwd 12, K2 6, K2-bwd 6, K4 7,
    K5 1, K6 1 a step, then the replay against an eager step from one state,
    batch and draws with the plain versions of the model's kernels and
    PyTorch's deterministic algorithms, every metric and the parameters,
    moments and EMA after the update bit for bit
    (``deterministic_replay_check``; K4-K6 stay, being deterministic); (d) a
    train step under
    ``use_visual_distill`` raises at ``attnpool``, as JAX's does.
24. The teacher's weak labels as the one rank of an NCCL group (world size
    1, as phase 17): the CLIP flagship with the RN50 teacher,
    ``use_imagenet_pusedo_labels``, ``clip_pusedo_th`` 0.05 and
    ``clip_pusedo_topk`` 4, bs2 at 896 x 1344 with bench.py's batch (300 GT
    slots, 16 valid) whose first image is an extra one: the train graph, 5
    replays (finite losses, the launches of phase 10), each step one
    gradient all-reduce and one gather of the rewritten batch's statistics
    (``parallel/dist.py:reduce_stats_``), counted by their wrappers and the
    NCCL kernels of a replay's guarded profile printed; the reduced
    statistics equal to the group-free ``tensor_stats`` of the same
    rewritten batch; the replay against an eager step as 23 (c). The group
    is destroyed at the end.
25. The masks path (run after 12, before 6, in a process of its own:
    ``masks_in_child``): ``dino_4scale_lvis.py`` with
    ``masks=True``, bf16, bs2 at 896 x 1344, random weights (seed 0), for the
    DETRsegm head and then CondInst (``phase_masks``): the eval graph, which
    does not run the head, in turns with the same detector without masks
    (ms/batch of both, K1 12 and K2 6 a batch, the replay against its eager
    body bit for bit); the forward's ``pred_masks`` (or ``mask_feats`` and
    ``mask_params``) at their production shapes, finite,
    ``postprocess_segm`` of the top-300 queries, the head alone (CUDA-event
    ms and the GB of its peak) and one batch against the plain versions;
    the train graph with bench.py's batch and ``masks`` (each valid GT
    box's extent at stride 8; bs1 where bs2 runs out of memory, both peaks
    printed): 3 replays with ``loss_mask`` and ``loss_dice`` finite and
    nonzero, the flagship's launches, ms/step and peak GB,
    ``graph_vs_eager``, a replay's busy ms, and the head's gradients against
    the plain versions (cosine >= 0.9).

``python3 chip_smoke.py kernels`` stops after the kernel phases (1-5, 8, 9, 12,
15 on its random cases, 16 and K7 on its constructed cases).
``python3 chip_smoke.py bwd`` runs phase 1, then phases 3 and 9 only.
``python3 chip_smoke.py k7`` runs phase 1, then phase 21's eval part only (the
eval graph and ``phase_k7`` on the eval's own boxes; ~30 s).
``python3 chip_smoke.py masks`` runs phase 1, then phase 25 only.
``python3 chip_smoke.py variants`` runs phases 1-5, 8, 9, 21 and 22;
``python3 chip_smoke.py teacher`` phases 1-5, 8, 9, 23 and 24. ``python3 chip_smoke.py backbones`` runs the
kernel phases 1-5, 8 and 9, then phases 18-20 only; ``python3 chip_smoke.py
knobs`` those kernel phases, then phase 20 only. ``python3 chip_smoke.py
sources`` runs phase 1, then ``phase_sources``: two eager flagship steps
from one state in both decoder routes under each of
``SOURCE_SETTINGS`` (the kernels or the plain versions, with or without
PyTorch's deterministic algorithms and cuDNN's deterministic mode, the
body's own cuDNN setting taken out), every leaf's gap written to
``build/sources.log``; two eager steps of every other trained path as
shipped; and the flagship's train graph timed under each setting.

``python3 chip_smoke.py ab [DIR]`` only times kernels of the port in DIR
(default: this checkout), for A/B runs of two trees: it imports
``richsem_tpu_torch`` from DIR, builds its kernels from DIR's sources, draws the
inputs of phases 2-5, 8 and 9 and prints one JSON line with, for K1 (encoder
and decoder, bf16), K3 and K3-bwd (the decoder, bf16), K1-bwd (encoder and
decoder), K2 and K2-bwd (N = 49,980), the CUDA-event time of a call and the
kernels' device time from ``profile_once`` (mean over 5 calls); for K1-bwd
and K3-bwd the tap kernel's device time, the wrapper's zeroed f32 d_value
and its cast where a tree has them, the device time of every operation of a
call (``all``) and of each part of the d_value pass the tree has
(``PASS_OPS``); and a SHA-256 prefix of the outputs of K1 (both cases), K3,
K3-bwd, K1-bwd (both), K2 and K2-bwd, and of each of K1-bwd's and K3-bwd's
three outputs apart. ``python3 chip_smoke.py ab DIR msda`` stops after
K1-bwd. It
then does the same for the probe kernels redesigned for Hopper,
``mxu_kernel`` at run_mxu's four shapes, ``fma_kernel`` at fma-1, 2, 4,
4-2acc and 4-chunk (event and device time, the bound, an output hash),
``tile_kernel`` at check_repeat_semantics' [8, 8] (beside the device time of
``x.repeat``), ``run_cell`` at phase 12's inputs (the device time of each of
its kernels and their sum, the bound, the hash, and whether two calls agree)
and ``run_vpu`` in bf16 at phase 12's inputs (device time, bound, hash),
``run_repeat`` in f32 and bf16 at phase 12's shapes (event and device time,
the bound, the hash), K4 on phase 15's correlated case (B 2, P 300 with 16
valid, O 900: event and device time, rounds, device time a round, a hash of the
assignment and the stats), K5 and K6 (both
orders) at phase 16's inputs (event and device time, hashes of K5's state
and of K6's parameters and moments after one call), and K7 on phase 21's
random bs2 x 300 case at threshold 0.7 and on N 1,024 (event and device
time, a hash of the keep mask). Compare
two trees in one call on the card, in turns, each in a process of
its own:

    for t in build/parent . . build/parent; do python3 chip_smoke.py ab $t; done

The kernels' JSON record lists the six kernels of the model, K4, K5, K6 and
K7 (its ``launches`` from phase 21's eval batches),
each with ``launches`` from the flagship train step (phase 10, K3 and
K3-bwd from phase 11), ``trainer_launches`` from phase 13,
``ddp_launches`` and ``ddp_replay_busy_ms`` from phase 17 and
``swin_launches`` from phase 18 (K1 and K2 also ``swin_eval_launches``,
and from phase 23 ``vit_eval_launches``), and the three probe
sources, each with the numbers of one headline call at the top, every call
under ``calls`` (each with ``device_ms`` beside the CUDA-event ``ms``, and
``library_device_ms``), and ``launches`` summed over its kernels in the
probes' ``main()`` runs.

TF32 is off for every matmul and convolution here. The second-to-last line is
the kernels' JSON record, the last ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero before those lines.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "richsem", "richsem_4scale_lvis.py")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "richsem", "dino_4scale_lvis.py")
BATCH, CANVAS, N_BATCHES, N_STEPS, N_SEP_STEPS = 2, (896, 1344), 3, 5, 2
MAX_GT, N_VALID = 300, 16  # bench.py's GT pad and valid count
SHAPES = ((112, 168), (56, 84), (28, 42), (14, 21))  # the 896 x 1344 pyramid
DEVICE = "cuda"
KERNELS = ("ms_deform_attn_fwd", "ms_deform_attn_bwd", "fused_encoder_tail_fwd",
           "fused_encoder_tail_bwd", "ms_deform_attn_sep_fwd", "ms_deform_attn_sep_bwd",
           "auction", "adamw", "probe_cal", "probe_cell", "probe_vpu_model", "nms")
# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and f32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
BF16_VEC_FLOPS = 133.8e12  # bf16 outside the tensor cores (NVIDIA's H100 white paper, SXM5)
# The CUDA cores' rates by instruction: the published figures count a fused
# multiply-add as two operations, but the probe kernels round every operation
# on its own (__fadd_rn / __fmul_rn, or one bf16 rounding after each, as their
# JAX kernels do), so no FMA can do two of them: each costs one instruction,
# 128 f32 or 256 packed bf16 results a clock an SM, half of each figure.
F32_ISSUE_OPS, BF16_VEC_ISSUE_OPS = F32_FLOPS / 2, BF16_VEC_FLOPS / 2
COS_MIN = 0.9  # least gradient cosine, kernels vs plain versions (phases 7, 10, 11)
NO_SPILL = ("ms_deform_attn_fwd", "ms_deform_attn_bwd", "fused_encoder_tail_fwd",
            "fused_encoder_tail_bwd", "ms_deform_attn_sep_fwd",
            "ms_deform_attn_sep_bwd", "auction", "adamw", "nms")  # ptxas: 0 spill bytes
# kernels that must spill nothing in sources that hold other kernels too
NO_SPILL_KERNELS = {"probe_cal": ("mxu_kernel", "vpu_bf16_kernel", "repeat_f32_kernel",
                                  "repeat_bf16_kernel"),
                    "probe_cell": ("cell_kernel", "cell_reduce_kernel"),
                    "probe_vpu_model": ("fma_kernel",)}
VALID = (800, 1224)  # bench.py's valid extent inside CANVAS


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
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


def bound(nbytes: float, flops: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and operations
    over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare_rel(name, kernel_out, plain_out, rel):
    """max |kernel - plain| <= rel * max |plain|; -> max abs error."""
    import torch

    a, b = kernel_out.float(), plain_out.float()
    if not torch.isfinite(a).all():
        fail(f"{name}: kernel output is not finite")
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    ok = err <= rel * scale
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {rel:g} * max|plain| = {rel * scale:.3e})"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def compare(name, kernel_out, plain_out, atol, rtol):
    import torch

    a, b = kernel_out.float(), plain_out.float()
    if not torch.isfinite(a).all():
        fail(f"{name}: kernel output is not finite")
    err = float((a - b).abs().max())
    ok = bool(torch.allclose(a, b, atol=atol, rtol=rtol))
    print(f"  {name}: max_abs_err {err:.3e} (tolerance atol {atol:g} + rtol {rtol:g} * |plain|)"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def phase_build():
    import torch

    from richsem_tpu_torch.bench import card
    from richsem_tpu_torch.ops import _build

    smi = card(torch.device("cuda"))
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("TF32 off for matmuls and convolutions; bf16 matmuls reduce in f32")
    t0 = time.perf_counter()
    _build.build_all(KERNELS)  # one nvcc per source, all at once
    for name in KERNELS:
        _build.load(name)
        for line in _build.build_log(name).splitlines():
            # and any ptxas note that it serialised wgmma products
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"  {name}: {line.strip()}")
    for name in NO_SPILL:
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", _build.build_log(name))
        if not spills or any(int(b) for b in spills):
            fail(f"{name}: ptxas reports spills (or no report): {spills}")
    for name, kernels in NO_SPILL_KERNELS.items():
        props = re.findall(r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes "
                           r"spill stores, (\d+) bytes spill loads", _build.build_log(name))
        for kernel in kernels:
            mine = [(f, int(st) + int(ld)) for f, st, ld in props if kernel in f]
            if not mine or any(b for _, b in mine):
                fail(f"{name}.cu {kernel}: ptxas reports spills (or no report): {mine}")
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s; {', '.join(NO_SPILL)}, "
          f"{', '.join(k for ks in NO_SPILL_KERNELS.values() for k in ks)} spill nothing",
          flush=True)
    return smi


def k1_cases():
    """Production K1 inputs: the encoder (B2, Q = S = 24,990, offsets clamped to
    +-5.5) and the decoder of the train step (1,100 box queries, unclamped,
    some taps out of bounds)."""
    import torch

    from richsem_tpu_torch.models.transformer_utils import encoder_reference_points
    from richsem_tpu_torch.ops import ms_deform_attn as k1

    g = torch.Generator(device=DEVICE).manual_seed(1)
    dev = DEVICE
    b, m, d, n_lvl, p = BATCH, 8, 32, 4, 4
    s = sum(h * w for h, w in SHAPES)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def softmax_aw(q):
        return torch.softmax(randn(b, q, m, n_lvl * p), -1).reshape(b, q, m, n_lvl, p)

    value = randn(b, s, m, d)
    vr = torch.ones(b, n_lvl, 2, device=dev)
    refs = encoder_reference_points(SHAPES, vr)
    offs = (torch.rand((b, s, m, n_lvl, p, 2), generator=g, device=dev) * 2 - 1) * 5.5
    cases = {"encoder": (k1.compute_sampling_locations(refs, offs, SHAPES, p), softmax_aw(s))}
    q = 1100
    boxes = torch.cat([torch.rand((b, q, 1, 2), generator=g, device=dev),
                       torch.rand((b, q, 1, 2), generator=g, device=dev) * 0.5 + 0.02],
                      -1).expand(b, q, n_lvl, 4)
    cases["decoder"] = (k1.compute_sampling_locations(boxes, randn(b, q, m, n_lvl, p, 2) * 2,
                                                      SHAPES, p), softmax_aw(q))
    return value, cases


def k1_taps(loc) -> int:
    return loc[..., 0].numel()  # B*Q*M*L*P


def phase_k1(value, cases):
    import torch

    from richsem_tpu_torch.ops import ms_deform_attn as k1

    rec = {"name": "ms_deform_attn_fwd", "route": "cuda",
           "source": "richsem_tpu_torch/csrc/ms_deform_attn_fwd.cu",
           "replaces": "richsem_tpu/ops/ms_deform_attn_pallas2.py:265", "library_ms": None}
    errs = []
    for case, (loc, aw) in cases.items():
        for dtype, atol, rtol in ((torch.bfloat16, 1e-2, 1e-2), (torch.float32, 5e-5, 0.0)):
            v = value.to(dtype)
            out = k1.ms_deform_attn(v, SHAPES, loc, aw)
            ref = k1.ms_deform_attn_plain(v, SHAPES, loc, aw)
            torch.cuda.synchronize()
            tag = f"K1 {case} Q={loc.shape[1]} {str(dtype)[6:]}"
            errs.append(compare(tag, out, ref, atol, rtol))
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: k1.ms_deform_attn(v, SHAPES, loc, aw))
                plain_ms = cuda_ms(lambda: k1.ms_deform_attn_plain(v, SHAPES, loc, aw), iters=5)
                # 4 corners x (multiply + add) per tap and channel
                bms, by = bound(nbytes(v, loc, aw, out), 8 * k1_taps(loc) * v.shape[-1],
                                F32_FLOPS)
                print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {bms:.4f} ms ({by})", flush=True)
                key = "" if case == "encoder" else "decoder_"
                rec[f"{key}ms"], rec[f"{key}plain_ms"] = ms, plain_ms
                rec[f"{key}bound_ms"], rec[f"{key}bound_by"] = bms, by
                if case == "decoder":  # the CUDA-event time of so short a call is the host's
                    rec["decoder_device_ms"] = device_ms(
                        lambda: k1.ms_deform_attn(v, SHAPES, loc, aw),
                        ["msda_fwd_kernel"])["msda_fwd_kernel"]
    # Tolerances: both versions sum the 64 taps in f32, in another order and
    # with or without fused multiply-adds. In f32 that moves a sum of terms
    # below 4 by a few ulps each, under 5e-5 in all; in bf16 the sum is then
    # rounded once, and the two may land one bf16 step apart (at most 2^-6
    # below 4, i.e. within 1e-2 + 1e-2 * |plain|).
    rec["max_abs_err"] = max(errs)
    print("phase 2: K1 matches its plain version", flush=True)
    return rec


def k1_valid_case():
    """The encoder's K1 inputs with bench.py's valid extent (VALID inside
    CANVAS): reference points scaled by valid ratios below 1 that differ by
    level (F3's geometry), offsets clamped to +-5.5 as in the model."""
    import torch

    from richsem_tpu_torch.models.transformer_utils import encoder_reference_points
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.utils.misc import resize_mask, valid_ratios

    g = torch.Generator(device=DEVICE).manual_seed(5)
    b, m, n_lvl, p = BATCH, 8, 4, 4
    s = sum(h * w for h, w in SHAPES)
    pad = torch.ones((b, *CANVAS), dtype=torch.bool, device=DEVICE)
    pad[:, : VALID[0], : VALID[1]] = False
    vr = torch.stack([valid_ratios(resize_mask(pad, hw)) for hw in SHAPES], dim=1)
    refs = encoder_reference_points(SHAPES, vr)
    offs = (torch.rand((b, s, m, n_lvl, p, 2), generator=g, device=DEVICE) * 2 - 1) * 5.5
    aw = torch.softmax(torch.randn((b, s, m, n_lvl * p), generator=g, device=DEVICE), -1)
    return k1.compute_sampling_locations(refs, offs, SHAPES, p), aw.reshape(b, s, m, n_lvl, p)


N_REPEAT = 20  # launches of K1-bwd and K3-bwd on one input that must agree bit for bit
F3_CANVAS, F3_VALID = (256, 384), (200, 300)  # ROADMAP F3's canvas and valid extent
MEMSET_OPS = {"memset": "Memset"}  # the d_value pass's zeroed counts


def bwd_kernels(sep: bool):
    """The __global__ functions of K1-bwd or K3-bwd: the d_value pass's count
    and shift kernels, the tap kernel (which adds the d_value terms), the
    convert kernel."""
    from richsem_tpu_torch.utils.profiling import DVALUE_PASS

    return ("msda_sep_bwd_kernel" if sep else "msda_bwd_kernel", *DVALUE_PASS)


def bwd_device_ms(fn, sep: bool):
    """-> (the device ms of one backward call, all its kernels and the memset
    of its counts; {operation: ms}), from five profiled calls."""
    dev = device_ms(fn, bwd_kernels(sep), also=MEMSET_OPS)
    return total_ms(dev), dev


def same_bits(a, b) -> bool:
    """Whether two tensors of one dtype hold the same bits (NaNs included)."""
    import torch

    ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def dvalue_check(tag, d_value, oracle):
    """A backward kernel's d_value against the fixed-point oracle of its wrapper
    module (``ms_deform_attn_dvalue_plain``, ``ms_deform_attn_sep_dvalue_plain``)
    on the same inputs: bit for bit."""
    import torch

    same = same_bits(d_value, oracle)
    if not same:
        ints = {4: torch.int32, 2: torch.int16}[d_value.element_size()]
        n = int((d_value.view(ints) != oracle.view(ints)).sum())
    print(f"  {tag} d_value bit for bit equal to the fixed-point oracle: {same}"
          + ("" if same else f" ({n} elements differ)"), flush=True)
    if not same:
        fail(f"{tag}: d_value differs from the fixed-point oracle")


def nonfinite_check(tag, bwd, oracle, args):
    """A g with one infinity: every d_value row that a term reaches is NaN, with
    the oracle's bits."""
    import torch

    v, shapes, loc, aw, grad = args
    grad = grad.clone()
    grad.view(-1)[0] = float("inf")
    want = oracle(v, shapes, loc, aw, grad)
    n_nan = int(torch.isnan(want.float()).sum())
    if not n_nan:
        fail(f"{tag}: the oracle gives no NaN for a g with an infinity")
    dvalue_check(f"{tag} (g with an infinity: {n_nan} NaNs)", bwd(v, shapes, loc, aw, grad)[0],
                 want)


def repeat_check(tag, fn, n=N_REPEAT):
    """``n`` launches of a backward wrapper ``fn`` on one input: every output
    (d_value, d_loc, d_aw) equal to the first launch's bit for bit."""
    import torch

    first = [t.clone() for t in fn()]
    differ = set()
    for _ in range(n - 1):
        for name, a, b in zip(("d_value", "d_loc", "d_aw"), fn(), first):
            if not torch.equal(a, b):
                differ.add(name)
    torch.cuda.synchronize()
    print(f"  {tag}: {n} launches, d_value, d_loc and d_aw bit for bit equal to the first's: "
          f"{not differ}", flush=True)
    if differ:
        fail(f"{tag}: {n} launches on one input differ in {sorted(differ)}")


def msda_edge_cases():
    """Two inputs of K1-bwd and K3-bwd beside the production ones, each
    (spatial shapes, value, loc, aw): (a) F3's 256 x 384 canvas with a
    200 x 300 valid extent (valid ratios that differ by level) and every
    encoder offset on the clamp's edge, +-5.5 px, each coordinate's sign drawn;
    (b) 1,100 unclamped decoder queries on the 896 x 1344 pyramid whose taps all
    lie within 1e-4 of the image's centre, so that every level's taps pile onto
    four value rows."""
    import torch

    from richsem_tpu_torch.models.transformer_utils import encoder_reference_points
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.utils.misc import resize_mask, valid_ratios

    g = torch.Generator(device=DEVICE).manual_seed(6)
    b, m, d, n_lvl, p = BATCH, 8, 32, 4, 4

    def aw_of(q):
        aw = torch.softmax(torch.randn((b, q, m, n_lvl * p), generator=g, device=DEVICE), -1)
        return aw.reshape(b, q, m, n_lvl, p)

    shapes = tuple((-(-F3_CANVAS[0] // st), -(-F3_CANVAS[1] // st)) for st in (8, 16, 32, 64))
    s = sum(h * w for h, w in shapes)
    pad = torch.ones((b, *F3_CANVAS), dtype=torch.bool, device=DEVICE)
    pad[:, : F3_VALID[0], : F3_VALID[1]] = False
    vr = torch.stack([valid_ratios(resize_mask(pad, hw)) for hw in shapes], dim=1)
    refs = encoder_reference_points(shapes, vr)
    sign = torch.rand((b, s, m, n_lvl, p, 2), generator=g, device=DEVICE) < 0.5
    offs = torch.where(sign, 5.5, -5.5)
    cases = {"F3 clamp edge": (shapes, torch.randn((b, s, m, d), generator=g, device=DEVICE),
                               k1.compute_sampling_locations(refs, offs, shapes, p), aw_of(s))}
    q, s = 1100, sum(h * w for h, w in SHAPES)
    loc = 0.5 + 1e-4 * torch.randn((b, q, m, n_lvl, p, 2), generator=g, device=DEVICE)
    cases["piled decoder"] = (SHAPES, torch.randn((b, s, m, d), generator=g, device=DEVICE), loc,
                              aw_of(q))
    return cases


def phase_k1_bwd(value, cases):
    """K1-bwd against autograd through the plain version, same inputs and g: the
    encoder, the decoder, the encoder with bench.py's valid extent and
    ``msda_edge_cases``; ``N_REPEAT`` launches at the encoder's and the
    decoder's shapes, bit for bit."""
    import torch

    from richsem_tpu_torch.ops import ms_deform_attn as k1

    g = torch.Generator(device=DEVICE).manual_seed(3)
    rec = {"name": "ms_deform_attn_bwd", "route": "cuda",
           "source": "richsem_tpu_torch/csrc/ms_deform_attn_bwd.cu",
           "replaces": "richsem_tpu/ops/ms_deform_attn_pallas2.py:306", "library_ms": None}
    errs = []
    all_cases = {case: (SHAPES, value, *c) for case, c in cases.items()}
    all_cases["encoder_valid"] = (SHAPES, value, *k1_valid_case())
    all_cases.update(msda_edge_cases())
    for case, (shapes, val, loc, aw) in all_cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            v = val.to(dtype)
            b, q, m = loc.shape[:3]
            grad = torch.randn((b, q, m * v.shape[-1]), generator=g, device=DEVICE).to(dtype)

            def plain():
                leaves = [t.detach().requires_grad_() for t in (v, loc, aw)]
                y = k1.ms_deform_attn_plain(leaves[0], shapes, leaves[1], leaves[2])
                return torch.autograd.grad(y, leaves, grad)

            def kernel():
                return k1.ms_deform_attn_backward(v, shapes, loc, aw, grad)

            ref = plain()
            out = kernel()
            torch.cuda.synchronize()
            tag = f"K1-bwd {case} Q={q} {str(dtype)[6:]}"
            dvalue_check(tag, out[0], k1.ms_deform_attn_dvalue_plain(v, shapes, loc, aw, grad))
            if case == "decoder":
                nonfinite_check(tag, k1.ms_deform_attn_backward, k1.ms_deform_attn_dvalue_plain,
                                (v, shapes, loc, aw, grad))
            # f32: each d_value element is the fixed-point sum of its terms, near
            # exact, where autograd adds them in f32 in its order, and the lane
            # sums of d_loc and d_aw run in another order: a few ulps of each
            # sum; bf16: d_value is rounded to bf16 once, and may land one bf16
            # step (2^-8 relative) apart where the f32 sums differ in their last
            # bits.
            rel = 1e-4 if dtype == torch.float32 else 1e-2
            for name, o, r in zip(("d_value", "d_loc", "d_aw"), out, ref):
                errs.append(compare_rel(f"{tag} {name}", o, r, rel))
            if case in ("encoder", "decoder"):
                repeat_check(tag, kernel)
            if dtype == torch.bfloat16 and case == "piled decoder":
                # every red of a level on four rows' integers: timed, no target
                dev_ms, split = bwd_device_ms(kernel, sep=False)
                rec["piled_device_ms"] = dev_ms
                print(f"  {tag}: device {dev_ms} ms a call: "
                      + ", ".join(f"{k} {v_}" for k, v_ in split.items()), flush=True)
            if dtype == torch.bfloat16 and case in ("encoder", "decoder", "encoder_valid"):
                ms = cuda_ms(kernel)
                plain_ms = cuda_ms(plain, iters=3, warmup=1)
                # per tap and channel: the sample (8), its x and y derivatives
                # (10), the three products with g (6), the four d_value terms (8)
                bms, by = bound(nbytes(v, loc, aw, grad, *out),
                                32 * k1_taps(loc) * v.shape[-1], F32_FLOPS)
                print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {bms:.4f} ms ({by})", flush=True)
                key = {"encoder": "", "decoder": "decoder_", "encoder_valid": "valid_extent_"}[case]
                rec[f"{key}ms"], rec[f"{key}plain_ms"] = ms, plain_ms
                rec[f"{key}bound_ms"], rec[f"{key}bound_by"] = bms, by
                if case != "encoder_valid":  # the decoder's CUDA-event time is the host's
                    dev_ms, split = bwd_device_ms(kernel, sep=False)
                    rec[f"{key}device_ms"] = dev_ms
                    print(f"  {tag}: device {dev_ms} ms a call: "
                          + ", ".join(f"{k} {v_}" for k, v_ in split.items()), flush=True)
    rec["max_abs_err"] = max(errs)
    rec["repeat_launches"] = N_REPEAT
    print("phase 3: K1-bwd matches the plain version's autograd gradient and repeats bit for bit",
          flush=True)
    return rec


def k3_cases(v, loc, aw, dtype, grad=None):
    """K3's and K3-bwd's checks at one dtype: the decoder's shapes, then odd
    row counts (B1, Q 37 and M 1 or 3: 37 and 111 rows), where the last warp's
    spare half-warp runs. -> (tag, wrapper arguments) pairs."""
    b, q, m = loc.shape[:3]
    out = [(f"decoder Q={q}", (v, SHAPES, loc, aw) + ((grad,) if grad is not None else ()))]
    for mo in (1, 3):
        args = (v[:1, :, :mo].contiguous(), SHAPES, loc[:1, :37, :mo].contiguous(),
                aw[:1, :37, :mo].contiguous())
        if grad is not None:
            d = v.shape[-1]
            args += (grad.reshape(b, q, m, d)[:1, :37, :mo].reshape(1, 37, mo * d).contiguous(),)
        out.append((f"rows={37 * mo}", args))
    return [(f"{tag} {str(dtype)[6:]}", args) for tag, args in out]


def phase_k3(value, loc, aw):
    """K3 (the separable decoder sampler) against its plain dense version at
    the decoder's shapes (1,100 box queries, unclamped, some taps out)."""
    import torch

    from richsem_tpu_torch.ops import ms_deform_attn_sep as k3

    rec = {"name": "ms_deform_attn_sep_fwd", "route": "cuda",
           "source": "richsem_tpu_torch/csrc/ms_deform_attn_sep_fwd.cu",
           "replaces": "richsem_tpu/ops/ms_deform_attn_sep_pallas.py:77", "library_ms": None}
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        v = value.to(dtype)
        for tag, args in k3_cases(v, loc, aw, dtype):
            out = k3.ms_deform_attn_sep(*args)
            ref = k3.ms_deform_attn_sep_plain(*args)
            torch.cuda.synchronize()
            # Both round hxw and rh where the TPU kernel does and sum in f32 in
            # another order: f32 within 5e-5 of the largest magnitude; bf16 may
            # land one bf16 step apart, as K1 (1e-2 + 1e-2 * |plain|)
            if dtype == torch.float32:
                errs.append(compare_rel(f"K3 {tag}", out, ref, 5e-5))
            else:
                errs.append(compare(f"K3 {tag}", out, ref, 1e-2, 1e-2))
        if dtype == torch.bfloat16:
            tag = f"K3 decoder Q={loc.shape[1]} bf16"
            out = k3.ms_deform_attn_sep(v, SHAPES, loc, aw)
            ms = cuda_ms(lambda: k3.ms_deform_attn_sep(v, SHAPES, loc, aw))
            plain_ms = cuda_ms(lambda: k3.ms_deform_attn_sep_plain(v, SHAPES, loc, aw), iters=3,
                               warmup=1)
            # per sample and channel: two rows of (2 products + 1 add for r, the
            # hat product, the add into the sum)
            bms, by = bound(nbytes(v, loc, aw, out), 10 * k1_taps(loc) * v.shape[-1], F32_FLOPS)
            print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by})", flush=True)
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            # the CUDA-event time of so short a call is the host's
            rec["device_ms"] = device_ms(lambda: k3.ms_deform_attn_sep(v, SHAPES, loc, aw),
                                         ["msda_sep_fwd_kernel"])["msda_sep_fwd_kernel"]
    rec["max_abs_err"] = max(errs)
    print("phase 8: K3 matches its plain version", flush=True)
    return rec


def phase_k3_bwd(value, loc, aw):
    """K3-bwd against the plain version's explicit backward, same inputs and g:
    the decoder, odd row counts and ``msda_edge_cases``; ``N_REPEAT`` launches
    at the decoder's shapes, bit for bit."""
    import torch

    from richsem_tpu_torch.ops import ms_deform_attn_sep as k3

    g = torch.Generator(device=DEVICE).manual_seed(4)
    rec = {"name": "ms_deform_attn_sep_bwd", "route": "cuda",
           "source": "richsem_tpu_torch/csrc/ms_deform_attn_sep_bwd.cu",
           "replaces": "richsem_tpu/ops/ms_deform_attn_sep_pallas.py:109", "library_ms": None}
    errs = []
    edge = msda_edge_cases()
    for dtype in (torch.bfloat16, torch.float32):
        v = value.to(dtype)
        b, q, m = loc.shape[:3]
        grad = torch.randn((b, q, m * v.shape[-1]), generator=g, device=DEVICE).to(dtype)
        # d_value is the fixed-point sum of its terms, near exact, where the
        # dense products add them in f32; the warp sums of d_loc and d_aw run
        # in another order; bf16 rounds d_value once, and may land one step
        # (2^-8 relative) apart
        rel = 1e-4 if dtype == torch.float32 else 2e-2
        runs = k3_cases(v, loc, aw, dtype, grad)
        for case, (shapes, val, lc, a) in edge.items():
            gr = torch.randn((b, lc.shape[1], m * v.shape[-1]), generator=g,
                             device=DEVICE).to(dtype)
            runs.append((f"{case} Q={lc.shape[1]} {str(dtype)[6:]}",
                         (val.to(dtype), shapes, lc, a, gr)))
        for tag, args in runs:
            out = k3.ms_deform_attn_sep_backward(*args)
            ref = k3.ms_deform_attn_sep_backward_plain(*args)
            torch.cuda.synchronize()
            for name, o, r in zip(("d_value", "d_loc", "d_aw"), out, ref):
                errs.append(compare_rel(f"K3-bwd {tag} {name}", o, r, rel))
            dvalue_check(f"K3-bwd {tag}", out[0], k3.ms_deform_attn_sep_dvalue_plain(*args))
            if tag.startswith("piled") and dtype == torch.bfloat16:
                dev_ms, split = bwd_device_ms(lambda: k3.ms_deform_attn_sep_backward(*args),
                                              sep=True)
                rec["piled_device_ms"] = dev_ms
                print(f"  K3-bwd {tag}: device {dev_ms} ms a call: "
                      + ", ".join(f"{k} {v_}" for k, v_ in split.items()), flush=True)
        tag = f"K3-bwd decoder Q={q} {str(dtype)[6:]}"
        nonfinite_check(tag, k3.ms_deform_attn_sep_backward, k3.ms_deform_attn_sep_dvalue_plain,
                        (v, SHAPES, loc, aw, grad))

        def kernel():
            return k3.ms_deform_attn_sep_backward(v, SHAPES, loc, aw, grad)

        repeat_check(tag, kernel)
        if dtype == torch.bfloat16:
            out = kernel()
            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(
                lambda: k3.ms_deform_attn_sep_backward_plain(v, SHAPES, loc, aw, grad),
                iters=3, warmup=1)
            # per sample and channel, two rows of: r (3), g*r*dhat and its sum
            # (3), d_r (1), the two d_hxw products and sums (4), the two d_value
            # terms and their adds (4)
            bms, by = bound(nbytes(v, loc, aw, grad, *out), 30 * k1_taps(loc) * v.shape[-1],
                            F32_FLOPS)
            print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by})", flush=True)
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            # every device operation of a call: the tap kernel, the d_value pass
            # and its zeroed counts (no f32 scratch, no cast)
            rec["device_ms"], split = bwd_device_ms(kernel, sep=True)
            print(f"  {tag}: device {rec['device_ms']} ms a call: "
                  + ", ".join(f"{k} {v_}" for k, v_ in split.items()), flush=True)
    rec["max_abs_err"] = max(errs)
    rec["repeat_launches"] = N_REPEAT
    print("phase 9: K3-bwd matches the plain version's explicit backward and repeats bit for bit",
          flush=True)
    return rec


def k2_args():
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(2)
    n, d, f = BATCH * sum(h * w for h, w in SHAPES), 256, 2048

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEVICE) * scale

    args = (randn(n, d), randn(n, d, scale=0.5),
            randn(f, d, scale=d**-0.5), randn(f, scale=0.1),
            randn(d, f, scale=f**-0.5), randn(d, scale=0.1),
            1 + randn(d, scale=0.1), randn(d, scale=0.1),
            1 + randn(d, scale=0.1), randn(d, scale=0.1), 1e-5, torch.bfloat16)
    return args, randn(n, d)


def phase_k2(args):
    import torch

    from richsem_tpu_torch.ops import fused_ffn as k2

    n, d = args[0].shape
    f = args[2].shape[0]
    out = k2.encoder_tail(*args)
    ref = k2.encoder_tail_plain(*args)
    torch.cuda.synchronize()
    # one bf16 rounding step of h2 (2^-8 relative, |h2| < 4) that falls the
    # other way after a differently ordered f32 sum passes through LN2
    err = compare(f"K2 N={n} bf16", out, ref, 3e-2, 0.0)
    del ref
    # K2 computes LN1 as K2-bwd does (PyTorch's order and roundings), so that its
    # bf16(x) and relu masks are the plain version's: count where they differ
    seen = {}
    again = k2._encoder_tail_cuda(k2._cuda_args(*args[:10], args[11]), args[10], transients=seen)
    same = torch.equal(again, out)
    src, attn, w1, b1 = args[:4]
    eps, cdt = args[10:]
    x_p = k2._ln(src + attn, args[6].float(), args[7].float(), eps).to(cdt)
    mask_p = torch.relu(x_p @ w1.to(cdt).t() + b1.to(cdt)) > 0
    x_diff = int((seen["xb"] != x_p).sum())
    flips = int(((seen["h1"] > 0) != mask_p).sum())
    allowed = math.ceil(1e-5 * mask_p.numel())
    print(f"  K2 N={n}: bf16(x) differs from PyTorch's in {x_diff} of {x_p.numel()} elements; "
          f"{flips} of {mask_p.numel()} relu masks flip (at most {allowed}); the entry point "
          f"that writes them gives the same y bit for bit: {same}", flush=True)
    if flips > allowed:
        fail(f"K2: {flips} relu masks flip against the plain version; LN1's order mirrors "
             f"torch 2.11's mean, this is torch {torch.__version__}")
    if not same:
        fail("K2's two entry points disagree")
    del seen, again, x_p, mask_p
    ms = cuda_ms(lambda: k2.encoder_tail(*args))
    plain_ms = cuda_ms(lambda: k2.encoder_tail_plain(*args))
    # K2's two products on cuBLAS, as a yardstick (not library_ms: another function)
    xg = torch.randn((n, d), generator=torch.Generator(device=DEVICE).manual_seed(6),
                     device=DEVICE).to(torch.bfloat16)
    w1g, w2g = w1.to(torch.bfloat16), args[4].to(torch.bfloat16)
    gemm_ms = cuda_ms(lambda: torch.matmul(torch.matmul(xg, w1g.t()), w2g.t()))
    del xg
    # inputs as the kernel reads them: f32 streams, bf16 weights, f32 LN params
    bms, by = bound(nbytes(*args[:2], out) + 2 * (2 * d * f + f + d) + 4 * 4 * d,
                    4 * n * d * f, BF16_FLOPS)
    print(f"  K2 N={n} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by}), share {bms / ms:.3f}; gemm_ms {gemm_ms:.4f} "
          f"(torch.matmul [{n}x{d}]x[{d}x{f}] and back)", flush=True)
    profile_once(lambda: k2.encoder_tail(*args), top=3)
    print("phase 4: K2 matches its plain version", flush=True)
    return {"name": "fused_encoder_tail_fwd", "route": "cuda",
            "source": "richsem_tpu_torch/csrc/fused_encoder_tail_fwd.cu",
            "replaces": "richsem_tpu/ops/fused_ffn.py:82",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None, "gemm_ms": gemm_ms}


def phase_k2_bwd(args, dy):
    """K2-bwd against autograd through the plain tail: all ten gradients, at
    N = 49,980 and at the ragged N = 1 and 200 (the first rows of the same
    inputs); two calls at N = 49,980 bit for bit; one profiled call."""
    import torch

    from richsem_tpu_torch.ops import fused_ffn as k2

    n, d = args[0].shape
    f = args[2].shape[0]
    tensors, rest = list(args[:10]), args[10:]
    names = ("d_src", "d_attn", "dW1", "db1", "dW2", "db2", "ds1", "dsb1", "ds2", "dsb2")

    def plain(tensors, dy):
        leaves = [t.detach().requires_grad_() for t in tensors]
        y = k2.encoder_tail_plain(*leaves, *rest)
        return torch.autograd.grad(y, leaves, dy)

    def plain_x_mask(t_rows):
        """The plain version's bf16(x) and relu mask (h1 > 0)."""
        src, attn, w1, b1 = t_rows[:4]
        s1, sb1 = t_rows[6:8]
        eps, cdt = rest
        x = k2._ln(src + attn, s1.float(), sb1.float(), eps).to(cdt)
        return x, torch.relu(x @ w1.to(cdt).t() + b1.to(cdt)) > 0

    errs = []
    for rows in (n, 1, 200):
        t_rows = [t[:rows] for t in tensors[:2]] + tensors[2:]
        seen = {}
        out = k2.encoder_tail_backward(*t_rows, *rest, dy[:rows], transients=seen)
        out = (out[0], *out)  # du1 is the gradient of both src and attn_out
        ref = plain(t_rows, dy[:rows])
        torch.cuda.synchronize()
        # The row pass recomputes bf16(x) with LN1 summed in PyTorch's order
        # (as torch 2.11's CUDA mean reduces a 256-wide row), so that its relu
        # mask is the plain version's. A mask that flips moves its row of d_src
        # by a large part of the tolerance: count the flips, bound them, and
        # check the rows without one on their own, so that a PyTorch that
        # reduces in another order shows here by name.
        x_p, mask_p = plain_x_mask(t_rows)
        x_diff = int((seen["xb"] != x_p).sum())
        flip = (seen["h1"] > 0) != mask_p
        flips, flip_rows = int(flip.sum()), flip.any(dim=1)
        allowed = math.ceil(1e-5 * flip.numel())
        print(f"  K2-bwd N={rows}: bf16(x) differs from PyTorch's in {x_diff} of {x_p.numel()} "
              f"elements; {flips} of {flip.numel()} relu masks flip (at most {allowed}), in "
              f"{int(flip_rows.sum())} rows", flush=True)
        if flips > allowed:
            fail(f"K2-bwd: {flips} relu masks flip against the plain version; LN1's order "
                 f"mirrors torch 2.11's mean, this is torch {torch.__version__}")
        if flips:
            keep = ~flip_rows
            for name, o, r in zip(names[:2], out[:2], ref[:2]):
                compare_rel(f"K2-bwd N={rows} bf16 {name} (rows without a flip)", o[keep],
                            r[keep], 2e-2)
        del seen, x_p, mask_p, flip, flip_rows
        # bf16: the plain version rounds dW1, dW2, db2 and dx_ffn to bf16 (2^-8
        # relative) where the kernel keeps them f32, and a relu mask may flip
        # where a recomputed pre-activation lands one bf16 step apart; 2e-2 of
        # the largest magnitude covers both
        errs += [compare_rel(f"K2-bwd N={rows} bf16 {name}", o, r, 2e-2)
                 for name, o, r in zip(names, out, ref)]
        if rows == n:
            again = k2.encoder_tail_backward(*args, dy)
            same = all(torch.equal(a, b) for a, b in zip(out[1:], again))
            print(f"  K2-bwd N={n}: two calls bit for bit: {same}", flush=True)
            if not same:
                fail("K2-bwd is not bit-reproducible")
            del again, out, ref
            ms = cuda_ms(lambda: k2.encoder_tail_backward(*args, dy), iters=10)
            plain_ms = cuda_ms(lambda: plain(tensors, dy), iters=5, warmup=1)
            bms, by = bound(nbytes(*args[:2], dy, args[0]) + 2 * (2 * d * f + f + d) + 4 * 4 * d
                            + 4 * (2 * d * f + f + 5 * d), 12 * n * d * f, BF16_FLOPS)
            print(f"  K2-bwd N={n} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by})")
            if ms >= plain_ms:
                fail("K2-bwd is not faster than its plain version")
            profile_once(lambda: k2.encoder_tail_backward(*args, dy), top=6)
    print("phase 5: K2-bwd matches the plain version's autograd gradient", flush=True)
    return {"name": "fused_encoder_tail_bwd", "route": "cuda",
            "source": "richsem_tpu_torch/csrc/fused_encoder_tail_bwd.cu",
            "replaces": "richsem_tpu/ops/fused_ffn.py:93",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


@contextlib.contextmanager
def sync_debug():
    """``torch.cuda.set_sync_debug_mode("error")`` around the block, after a
    check that the mode is live (an ``.item()`` must raise under it, and
    whether a blocking host-to-device copy does is printed). -> a list that
    gets the error the block raised, if any."""
    import torch

    caught, probe = [], torch.zeros(1, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for what, fn in (("item", lambda: probe.item()),
                         ("host-to-device copy", lambda: torch.tensor([1.0], device=DEVICE))):
            try:
                fn()
                refused = False
            except RuntimeError:
                refused = True
            if what == "item" and not refused:
                fail("set_sync_debug_mode('error') let .item() through")
            if what != "item":
                print(f"  sync debug mode refuses a blocking {what}: {refused}", flush=True)
        try:
            yield caught
        except RuntimeError as e:
            caught.append(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def eval_batch(g, canvas):
    """An eval batch of BATCH random images on ``canvas`` with bench.py's valid
    extent (96 rows and 120 columns of padding)."""
    import torch

    h, w = canvas
    pad = torch.ones(BATCH, h, w, dtype=torch.bool, device=DEVICE)
    pad[:, : h - 96, : w - 120] = False
    return {"images": torch.rand((BATCH, h, w, 3), generator=g, device=DEVICE) * 2 - 1,
            "pad_mask": pad,
            "orig_size": torch.tensor([[h - 96, w - 120]] * BATCH, device=DEVICE)}


def graph_checks(model, cfg, step, batches, text_embed, g):
    """The eval step's CUDA graphs: the replay against the eager body on the
    same batch and weights, bit for bit (the same kernels in the same order,
    and the forward has no atomics), at two keys, bs2 896 x 1344 and
    1344 x 896; one replay under ``set_sync_debug_mode("error")``; the capture
    ms of each key and the shared pool's memory; the guarded profile of a
    replay (busy ms, operations, idle share)."""
    import torch

    from richsem_tpu_torch.bench import guarded_profile
    from richsem_tpu_torch.train.engine import eval_forward, graph_key

    for canvas, batch in ((CANVAS, batches[0]), (CANVAS[::-1], eval_batch(g, CANVAS[::-1]))):
        graphed = step(batch, text_embed)
        with torch.inference_mode():
            eager = eval_forward(model, cfg, batch, text_embed)
        torch.cuda.synchronize()
        same = all(torch.equal(graphed[k], eager[k]) for k in ("scores", "labels", "boxes"))
        cap = step.graphs[graph_key(batch, text_embed)].capture_ms
        print(f"  graph bs{BATCH} {canvas[0]}x{canvas[1]}: replay equals the eager body bit for "
              f"bit: {same}; warm-up + capture {cap:.1f} ms", flush=True)
        if not same:
            fail(f"the eval step's graph at {canvas} differs from its eager body")
    torch.cuda.synchronize()
    with sync_debug() as caught:
        step(batches[1], text_embed)
    if caught:
        fail(f"a replay of the eval graph synchronises: {caught[0]}")
    torch.cuda.synchronize()
    print(f"  a replay under set_sync_debug_mode('error'): no synchronisation; {len(step.graphs)} "
          f"graphs share one pool of {step.pool_bytes / 1e9:.3f} GB", flush=True)
    prof, retakes = guarded_profile(lambda: step(batches[1], text_embed))
    print(f"  replay profile: busy {prof.busy_ms:.2f} ms of {prof.wall_ms:.2f} ms, "
          f"{prof.n_ops} device operations, idle share {prof.idle_share:.3f}, {retakes} retakes",
          flush=True)


def phase_eval(k1_rec, k2_rec):
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.models import dino, layers
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.train.engine import eval_forward, make_eval_step

    cfg = Config.fromfile(CONFIG)
    cfg.compute_dtype = "bfloat16"
    g = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    text_embed = torch.randn((cfg.num_classes, 1024), generator=g, device=DEVICE)
    batches = [eval_batch(g, CANVAS) for _ in range(N_BATCHES + 1)]
    step = make_eval_step(model, cfg)
    step(batches[-1], text_embed)  # warm-up and capture of the graph (cuDNN, allocator)
    torch.cuda.synchronize()
    print(f"  setup + warm-up {time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    k1.ms_deform_attn.launches = 0
    k2.encoder_tail.launches = 0
    times, results = [], []
    for batch in batches[:N_BATCHES]:
        t = time.perf_counter()
        results.append(step(batch, text_embed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    n_k1, n_k2 = k1.ms_deform_attn.launches, k2.encoder_tail.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in results:
        if r["scores"].shape != (BATCH, cfg.num_select) or r["labels"].shape != (BATCH, cfg.num_select):
            fail(f"eval output shapes {r['scores'].shape} {r['labels'].shape}")
        if r["boxes"].shape != (BATCH, cfg.num_select, 4):
            fail(f"eval box shape {r['boxes'].shape}")
        if not all(torch.isfinite(r[k].float()).all() for k in ("scores", "boxes")):
            fail("eval outputs are not finite")
        if not ((r["labels"] >= 0) & (r["labels"] < cfg.num_classes)).all():
            fail("labels out of range")
    print(f"  outputs: scores/labels {tuple(results[0]['scores'].shape)}, boxes "
          f"{tuple(results[0]['boxes'].shape)}, finite; top score {float(results[0]['scores'].max()):.4f}")
    per_fwd = cfg.enc_layers + cfg.dec_layers, cfg.enc_layers
    print(f"  launches over {N_BATCHES} forwards: K1 {n_k1} (expect {per_fwd[0] * N_BATCHES}), "
          f"K2 {n_k2} (expect {per_fwd[1] * N_BATCHES})")
    if (n_k1, n_k2) != (per_fwd[0] * N_BATCHES, per_fwd[1] * N_BATCHES):
        fail("the eval path did not launch K1 12 and K2 6 times per forward")
    k1_rec["eval_launches"], k2_rec["eval_launches"] = n_k1, n_k2
    ms_batch = statistics.median(times)
    print(f"  eval step (CUDA graph replays): {', '.join(f'{t:.2f}' for t in times)} ms/batch; "
          f"median {ms_batch:.2f} ms/batch = {BATCH * 1e3 / ms_batch:.3f} img/s; "
          f"peak memory {peak_gb:.2f} GB", flush=True)
    graph_checks(model, cfg, step, batches, text_embed, g)

    # The same forward with the plain versions in place of K1 and K2, compared
    # at the encoder output. (Past it, the top-900 selection among 24,990
    # near-tied random-weight scores reorders under bf16 rounding noise, so
    # the decoder's queries are not comparable one to one.)
    batch = batches[0]
    memory = []
    hook = model.layers("encoder")[-1].register_forward_hook(
        lambda mod, args, result: memory.append(result))
    with torch.inference_mode():
        out = model(batch["images"], batch["pad_mask"], text_embed=text_embed)
        layers.ms_deform_attn, dino.encoder_tail = k1.ms_deform_attn_plain, k2.encoder_tail_plain
        try:
            ref = model(batch["images"], batch["pad_mask"], text_embed=text_embed)
        finally:
            layers.ms_deform_attn, dino.encoder_tail = k1.ms_deform_attn, k2.encoder_tail
    hook.remove()
    torch.cuda.synchronize()
    diff = (memory[0] - memory[1]).abs()
    overlap = min(
        len(set(a.tolist()) & set(b.tolist())) / a.numel()
        for a, b in zip(out["topk_idx"], ref["topk_idx"])
    )
    print(f"  kernels vs plain versions, one batch: encoder output max_abs_err "
          f"{float(diff.max()):.3e}, mean_abs_err {float(diff.mean()):.3e}; "
          f"two-stage selections overlap {overlap:.4f}", flush=True)
    # bf16 steps that round the other way (the K1/K2 checks above) feed six
    # layers: measured on an H100, max 2.6e-2 and mean 3.3e-3 at this seed,
    # and 98% of the 900 selected tokens shared
    if not (float(diff.mean()) < 1e-2 and overlap > 0.9):
        fail("the encoder with kernels departs from the one with plain versions")

    del memory, out, ref
    head_check(model, cfg, batch, text_embed)

    def eager():  # the graph replays the head it captured: F-P7 compares eager bodies
        with torch.inference_mode():
            eval_forward(model, cfg, batches[1], text_embed)

    head_profiles(eager, "eval batch (eager body)")
    print("phase 6: flagship eval step ok", flush=True)


HEAD_SITES = ("encoder output", "decoder stack", "selected queries")  # _class_logits' calls
# the most a top-300 score may move with the head's order of summation: a score
# is a sigmoid, so it moves by at most a quarter of its logit's change, under
# 1e-5 of the largest |logit| (~14)
HEAD_TIE = 1e-4


@contextlib.contextmanager
def plain_head():
    """The plain f32 product in place of the CLIP-align head's tensor-core one."""
    from richsem_tpu_torch.models import dino

    kept, dino.head_product = dino.head_product, dino.head_product_plain
    try:
        yield
    finally:
        dino.head_product = kept


def head_check(model, cfg, batch, text_embed):
    """F-P7: the CLIP-align head's bf16 tensor-core product against the plain f32
    product, on the operands of each of its sites in one eval forward, within
    1e-5 of the largest |logit| (products of bf16 values are exact in f32; only
    the order of the sums differs). Then the selections against the plain
    head's: the forward's top-900 as a set; the top-300 computed by both heads
    from the same decoder state, equal but for entries that tie the 300th to
    within HEAD_TIE; and the top-300 of a whole forward with each head, by
    (token, class)."""
    import torch

    from richsem_tpu_torch.models import dino

    calls, kept, state = [], dino.head_product, {}

    def record(v, t):
        calls.append((v, t))
        return kept(v, t)

    def forward():
        with torch.inference_mode():
            return model(batch["images"], batch["pad_mask"], text_embed=text_embed)

    def top(logits, tokens=None):  # -> per image {(query or token, class): score}
        k = cfg.num_select
        out = []
        for i, lg in enumerate(logits.float()):
            score, idx = torch.topk(lg.sigmoid().flatten(), k)
            q, c = (idx // lg.shape[-1]).tolist(), (idx % lg.shape[-1]).tolist()
            if tokens is not None:
                q = tokens[i][q].tolist()
            out.append(dict(zip(zip(q, c), score.tolist())))
        return out

    def compare(a, b):  # -> (least overlap, largest score change, crossings past HEAD_TIE)
        overlap, moved, far = 1.0, 0.0, 0
        for x, y in zip(a, b):
            both = x.keys() & y.keys()
            overlap = min(overlap, len(both) / cfg.num_select)
            moved = max([moved] + [abs(x[k] - y[k]) for k in both])
            for got in (x, y):
                far += sum(got[k] - min(got.values()) > HEAD_TIE for k in got.keys() - both)
        return overlap, moved, far

    hook = model.class_embed.register_forward_hook(lambda m, args, r: state.update(args=args))
    dino.head_product = record
    try:
        out = forward()
    finally:
        dino.head_product = kept
        hook.remove()
    if len(calls) != len(HEAD_SITES) or calls[0][0].dtype != torch.bfloat16:
        fail(f"F-P7: the eval forward reached the head {len(calls)} times "
             f"(expect {len(HEAD_SITES)}, bf16 operands)")
    for site, (v, t) in zip(HEAD_SITES, calls):
        compare_rel(f"F-P7 head product at the {site} {tuple(v.shape)} x {tuple(t.shape)}",
                    dino.head_product(v, t), dino.head_product_plain(v, t), 1e-5)
    del calls
    with torch.inference_mode():
        same = model.class_embed(*state["args"])[-1]
        with plain_head():
            same_ref = model.class_embed(*state["args"])[-1]
            ref = forward()
    del state
    sel = min(len(set(a.tolist()) & set(b.tolist())) / a.numel()
              for a, b in zip(out["topk_idx"], ref["topk_idx"]))
    head_overlap, head_moved, head_far = compare(top(same), top(same_ref))
    run_overlap, run_moved, _ = compare(top(out["pred_logits"], out["topk_idx"]),
                                        top(ref["pred_logits"], ref["topk_idx"]))
    print(f"  F-P7: top-{cfg.num_queries} selection overlap {sel:.4f} (in order: "
          f"{bool(torch.equal(out['topk_idx'], ref['topk_idx']))}); top-{cfg.num_select} from "
          f"one decoder state: overlap {head_overlap:.4f}, scores within {head_moved:.3e}, "
          f"{head_far} entries crossed the cut by more than {HEAD_TIE:g}", flush=True)
    print(f"  F-P7: whole forwards: top-{cfg.num_select} (token, class) overlap "
          f"{run_overlap:.4f}, shared scores within {run_moved:.3e} (the decoder runs the "
          f"selected tokens in the order of their near-tied scores, and its bf16 sums round "
          f"by that order)", flush=True)
    if sel < 0.999 or head_overlap < 0.999 or head_moved > HEAD_TIE or head_far:
        fail("F-P7: the tensor-core head changes the selections beyond ties")
    # as the encoder check above bounds the kernels' bf16 departures
    if run_overlap < 0.9 or run_moved > 1e-2:
        fail("F-P7: the forward with the tensor-core head departs from the plain head's")


def head_profiles(fn, what):
    """F-P7 before and after: ``fn`` profiled with the plain head, then with the
    tensor-core head, each guarded by the kernels' launch counts; prints the busy
    time, the f32 CUDA-core GEMMs (``ffma`` or ``sgemm`` in the name; count and
    device ms), the auction rounds a call and the busiest GEMMs. The f32
    CUDA-core GEMMs must fall by one for each forward product of the head
    (three a forward)."""
    import torch

    from richsem_tpu_torch.bench import guarded_profile
    from richsem_tpu_torch.models import dino
    from richsem_tpu_torch.ops import lap

    ffma, heads = {}, 0
    counter = lap.device_rounds(DEVICE)
    for label in ("plain head (before)", "tensor-core head (after)"):
        with (plain_head() if label.startswith("plain") else contextlib.nullcontext()):
            kept, calls = dino.head_product, []
            dino.head_product = lambda v, t: calls.append(1) or kept(v, t)
            torch.cuda.synchronize()
            counter.zero_()
            try:
                prof, retakes = guarded_profile(fn)
            finally:
                dino.head_product = kept
        rounds = int(counter) / (retakes + 1)  # guarded_profile synchronised
        f32 = [(n, ms) for key, n, ms in prof.ops if "gemm" in key.lower()
               and ("ffma" in key or "sgemm" in key)]
        ffma[label], heads = sum(n for n, _ in f32), len(calls) // (retakes + 1)
        print(f"  F-P7 {what}, {label}: busy {prof.busy_ms:.2f} ms, {prof.n_ops} operations, "
              f"idle share {prof.idle_share:.3f}, {retakes} retakes, auction rounds {rounds:g}, "
              f"head forward products {heads}; f32 CUDA-core GEMMs "
              f"{ffma[label]} launches, {sum(ms for _, ms in f32):.3f} ms; busiest GEMMs:")
        for key, n, ms in sorted((o for o in prof.ops if "gemm" in o[0].lower()),
                                 key=lambda o: -o[2])[:8]:
            print(f"    {ms:9.3f} ms  x{n:<4d} {key[:100]}")
    before, after = ffma.values()
    if before - after != heads:
        fail(f"F-P7: the {what}'s f32 CUDA-core GEMMs fell by {before - after}, not by the "
             f"head's {heads} forward products")


def train_batch(g):
    """bench.py's synthetic batch (bench.py:90-112), drawn on the card; ``size``
    is the valid (h, w) by which the teacher scales the GT boxes."""
    import torch

    h, w = CANVAS
    pad = torch.ones(BATCH, h, w, dtype=torch.bool, device=DEVICE)
    pad[:, : h - 96, : w - 120] = False
    return {
        "images": torch.rand((BATCH, h, w, 3), generator=g, device=DEVICE) * 2 - 1,
        "pad_mask": pad,
        "labels": torch.randint(0, 1203, (BATCH, MAX_GT), generator=g, device=DEVICE),
        "boxes": (torch.rand((BATCH, MAX_GT, 4), generator=g, device=DEVICE) * 0.6
                  + 0.1).clamp(0.02, 0.9),
        "valid": (torch.arange(MAX_GT, device=DEVICE) < N_VALID)[None].expand(BATCH, -1),
        "orig_size": torch.tensor([[h - 96, w - 120]] * BATCH, device=DEVICE),
        "size": torch.tensor([[h - 96, w - 120]] * BATCH, device=DEVICE),
        "is_extra": torch.zeros(BATCH, dtype=torch.bool, device=DEVICE),
    }


# leaves whose gradients the kernel and plain runs compare: the encoder's
# first FFN and sampling offsets (behind K2-bwd and K1-bwd), a decoder
# cross-attention (K1-bwd or K3-bwd at the decoder), the class head and a
# backbone conv; the flagship's class head is the CLIP-text one, and its
# distillation head (clip_visual_proj) is read too
GRAD_LEAVES = ("encoder_layer0.ffn.linear1.weight", "encoder_layer5.ffn.linear2.weight",
               "encoder_layer0.self_attn.sampling_offsets.weight",
               "encoder_layer0.self_attn.value_proj.weight",
               "decoder_layer3.cross_attn.value_proj.weight", "cls_kernel",
               "backbone.layer4_block2.conv3.weight")
FLAGSHIP_LEAVES = GRAD_LEAVES[:5] + ("class_embed.dino_visual_proj.weight",
                                     "clip_visual_proj.weight", GRAD_LEAVES[6])
# launches a train step of K1, K1-bwd, K2, K2-bwd, K3, K3-bwd, K4, K5, K6
COUNTED = ("K1", "K1-bwd", "K2", "K2-bwd", "K3", "K3-bwd", "K4", "K5", "K6")


def launch_counters():
    """The nine kernels' counters, in the order of COUNTED and of the records."""
    from richsem_tpu_torch.bench import launch_counters as by_name

    counters = by_name()
    return tuple(counters[k] for k in COUNTED)


@contextlib.contextmanager
def plain_model_kernels():
    """The plain versions in place of the model's kernels (K1 and K3, with the
    autograd backward of their plain versions, and K2), at the modules' call
    sites. K4, K5 and K6 stay: each is deterministic (phases 15 and 16 run
    them twice bit for bit) and graph-safe, where the plain auction reads the
    host."""
    from richsem_tpu_torch.models import dino, layers
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.ops import ms_deform_attn_sep as k3

    layers.ms_deform_attn, layers.ms_deform_attn_sep = (k1.ms_deform_attn_plain,
                                                        k3.ms_deform_attn_sep_plain)
    dino.encoder_tail = k2.encoder_tail_plain
    try:
        yield
    finally:
        layers.ms_deform_attn, layers.ms_deform_attn_sep = (k1.ms_deform_attn,
                                                            k3.ms_deform_attn_sep)
        dino.encoder_tail = k2.encoder_tail


@contextlib.contextmanager
def plain_versions():
    """The plain versions in place of every kernel, at the modules' call sites:
    the model's (``plain_model_kernels``) and the auction's."""
    from richsem_tpu_torch.models import matcher
    from richsem_tpu_torch.ops import lap

    matcher.batched_min_cost_assignment = (
        lambda c, v, max_iters=3000, eps_rel=1e-4: lap._auction(-c, v, max_iters, eps_rel)[0])
    try:
        with plain_model_kernels():
            yield
    finally:
        matcher.batched_min_cost_assignment = lap.batched_min_cost_assignment


def state_copy(state) -> dict:
    """A copy of what a train step changes: parameters, moments, EMA, counters."""
    opt = state.optimizer
    return {"params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
            "mu": [t.clone() for t in opt.mu], "nu": [t.clone() for t in opt.nu],
            "ema": None if state.ema is None else {k: t.clone() for k, t in state.ema.items()},
            "count": opt.count, "step": state.step}


def state_put(state, saved: dict) -> None:
    """Copy ``saved`` (``state_copy``) back into ``state`` in place, as the
    graphs need: they read and write the tensors they captured."""
    import torch

    opt = state.optimizer
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(saved["params"][n])
        for dst, src in ((opt.mu, saved["mu"]), (opt.nu, saved["nu"])):
            for a, b in zip(dst, src):
                a.copy_(b)
        for k, t in (state.ema or {}).items():
            t.copy_(saved["ema"][k])
    opt.count, state.step = saved["count"], saved["step"]


def ulp(x):
    """One rounding step at the float32 value ``x`` (a 0-d tensor)."""
    import torch

    return float(torch.nextafter(x.float(), torch.tensor(math.inf, device=x.device)) - x.float())


def param_spread(a: dict, b: dict):
    """-> {leaf: max |a - b|} over the parameters of two ``state_copy``s."""
    return {n: float((a["params"][n] - b["params"][n]).abs().max()) for n in a["params"]}


def param_l2(a: dict, b: dict) -> float:
    """The l2 distance of all the parameters of two ``state_copy``s."""
    return math.sqrt(sum(float((a["params"][n].double() - b["params"][n].double()).square().sum())
                         for n in a["params"]))


def graph_vs_eager(step, state, batch, text_embed=None, what="train"):
    """The replay against the eager body from one state: that state copied
    aside, one eager step (``TrainStep.eager``) and one replay on the same
    batch and draws, the state put back before each. Every metric, the loss
    and ``grad_norm`` included, and the state after the update (parameters,
    AdamW moments, EMA, counters) must be equal bit for bit: K1-bwd and
    K3-bwd sum d_value in a fixed-point pass that does not depend on the
    order of the blocks, and the body runs under PyTorch's deterministic
    algorithms (ROADMAP F-P6, repaired). Leaves the state as it found it."""
    import torch

    draws = step.draws(state, batch["labels"].shape[0])
    saved = state_copy(state)
    runs = []
    for run in (step.eager, step):
        metrics = run(state, batch, text_embed, draws=draws)
        torch.cuda.synchronize()
        runs.append(({k: v.clone() for k, v in metrics.items()}, state_copy(state)))
        state_put(state, saved)
    (e, se), (r, sr) = runs
    differ = [k for k in e if not torch.equal(r[k], e[k])]
    leaves = [n for n in se["params"] if not torch.equal(sr["params"][n], se["params"][n])]
    same = same_state(sr, se)
    print(f"  {what} graph vs one eager step (one state, batch and draws): metrics bit for bit "
          f"{len(e) - len(differ)}/{len(e)}; loss {float(r['loss']):.6f}, grad_norm "
          f"{float(r['grad_norm']):.9g} vs {float(e['grad_norm']):.9g}; parameters, moments "
          f"and EMA after the update bit for bit: {same} ({len(leaves)}/{len(se['params'])} "
          f"parameters differ)", flush=True)
    if differ or not same:
        fail(f"the {what} graph differs from the eager step: metrics {differ}, "
             f"{len(leaves)} parameters ({', '.join(leaves[:8])}), state equal {same}")


def two_runs(step, state, batches, text_embed=None, n=5):
    """``n`` replays from one state with one seed, twice, the state put back
    between: the losses and the state after them equal bit for bit (F-P6 over
    steps). Leaves the state as it found it."""
    import torch

    saved = state_copy(state)
    ends, losses = [], []
    for _ in range(2):
        losses.append([step(state, b, text_embed)["loss"] for b in batches[:n]])
        torch.cuda.synchronize()
        ends.append(state_copy(state))
        state_put(state, saved)
    d = [k for k in ends[0]["params"] if not torch.equal(ends[0]["params"][k],
                                                          ends[1]["params"][k])]
    same = same_state(*ends) and all(torch.equal(a, b) for a, b in zip(*losses))
    print(f"    {n} replays twice from one state and seed: losses and state bit for bit: "
          f"{same} ({len(d)}/{len(ends[0]['params'])} parameters differ); last loss "
          f"{float(losses[0][-1]):.6f}", flush=True)
    if not same:
        fail(f"{n} replays from one state and seed do not repeat bit for bit")


REPLAY_BUSY = {}  # the device ms of each train phase's profiled replay
F32_GEMMS = {}  # the f32 CUDA-core GEMMs of each train phase's replay (ROADMAP F-P10)
def free_memory() -> None:
    """Collect the garbage (a step's graphs can sit in reference cycles, their
    pool with them), then return the allocator's cached blocks to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def adamw_launches(opt):
    """(K5, K6) launches a step, from the optimizer's tables (``ops/adamw.py:plan``)."""
    from richsem_tpu_torch.ops.adamw import ADAMW_LEAVES, NORM_LEAVES, plan

    return (len(plan([t.numel() for t in opt.leaves()], NORM_LEAVES)),
            len(plan([p.numel() for _, p in opt.trainable], ADAMW_LEAVES)))


def f32_gemms(fn):
    """-> (launches, device ms) of the f32 CUDA-core GEMMs (``ffma`` or ``sgemm``
    in a GEMM's name) in one profiled call of ``fn``; (0, nan) unmeasured."""
    from richsem_tpu_torch.utils.profiling import profile_call

    prof = profile_call(fn)
    if prof is None:
        return 0, float("nan")
    f32 = [(n, ms) for key, n, ms in prof.ops
           if "gemm" in key.lower() and ("ffma" in key or "sgemm" in key)]
    return sum(n for n, _ in f32), sum(ms for _, ms in f32)


def run_train(cfg, want, n_steps, leaves, clip_model=None, text_embed=None, costs=None,
              phase=None, against_eager=None):
    """Build the detector from seed 0, take one warm-up step (eager; it
    captures the step's CUDA graph: capture ms and pool GB printed) and
    ``n_steps`` train steps, each a replay (launches checked against ``want``
    a step, the auction's rounds read from K4's device counter), one more
    replay under ``set_sync_debug_mode("error")`` (nothing may be read on the
    host), the replay against the eager body (``graph_vs_eager``) and two
    runs of five replays (``two_runs``), both bit for bit, compare the
    gradients of ``leaves`` in one step against the same step with the plain
    versions, and profile one replay (its operations and K4's device ms).
    ``costs``, if given, gets the cost matrices and masks of the warm-up
    step's matchings. With ``against_eager="one"`` ``two_runs`` is skipped
    (a step of the run's budget). K5's and K6's
    launches in ``want`` may be None: the optimizer's tables give them
    (``adamw_launches``). With ``phase``, the f32 CUDA-core GEMMs of one more
    replay are counted (``f32_gemms``, ROADMAP F-P10). -> the launches of the
    nine kernels over the steps."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.bench import KERNELS
    from richsem_tpu_torch.models import build_model, matcher
    from richsem_tpu_torch.ops import lap
    from richsem_tpu_torch.train.engine import (create_train_state, make_loss_fn,
                                                make_train_step, step_draws)
    from richsem_tpu_torch.train.optim import build_optimizer

    g = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1000),
                               use_ema=cfg.use_ema)
    step = make_train_step(model, cfg, seed=0, device=DEVICE, clip_model=clip_model)
    batches = [train_batch(g) for _ in range(n_steps + 1)]
    solve = matcher.batched_min_cost_assignment

    def keep(c, v, **kw):  # the eager step's matrices; a capture's hold no values
        if not torch.cuda.is_current_stream_capturing():
            costs.append((c.clone(), v.clone()))
        return solve(c, v, **kw)

    if costs is not None:
        matcher.batched_min_cost_assignment = keep
    try:
        m = step(state, batches[-1], text_embed)  # the eager step, then the graph's capture
    finally:
        matcher.batched_min_cost_assignment = solve
    torch.cuda.synchronize()
    (g_key, graph), = step.graphs.items()
    print(f"  setup + warm-up step {time.perf_counter() - t0:.1f} s, loss {float(m['loss']):.4f}; "
          f"the step's CUDA graph: warm-up + capture {graph.capture_ms:.1f} ms, pool "
          f"{step.pool_bytes / 1e9:.3f} GB", flush=True)

    want = tuple(want[:7]) + tuple(
        n if n is not None else t for n, t in zip(want[7:], adamw_launches(state.optimizer)))
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    counter = lap.device_rounds(DEVICE).zero_()
    times, metrics = [], []
    for batch in batches[:n_steps]:
        t = time.perf_counter()
        metrics.append(step(state, batch, text_embed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = [c.launches for c in counters]
    rounds = int(counter)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    for i, m in enumerate(metrics):
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        distill = ""
        if clip_model is not None:
            distill = (f", loss_distill {float(m['loss_distill']):.4f}, "
                       f"loss_distill_dn {float(m['loss_distill_dn']):.4f}")
        print(f"  step {i}: loss {loss:.4f}, grad_norm {gnorm:.4f}, loss_ce {float(m['loss_ce']):.4f}, "
              f"loss_bbox {float(m['loss_bbox']):.4f}, loss_giou {float(m['loss_giou']):.4f}, "
              f"loss_ce_dn {float(m['loss_ce_dn']):.4f}{distill}, "
              f"class_error {float(m['class_error']):.2f}, "
              f"offset_beyond_margin {float(m['offset_beyond_margin']):.5f}")
        if not (bool(m["finite"]) and math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"train step {i}: loss or grad_norm is not finite")
        if clip_model is not None and not (float(m["loss_distill"]) > 0
                                           and math.isfinite(float(m["loss_distill_dn"]))):
            fail(f"train step {i}: loss_distill is not positive or loss_distill_dn not finite")
    want = [n * n_steps for n in want]
    print(f"  launches over {n_steps} steps: "
          + ", ".join(f"{k} {n}" for k, n in zip(COUNTED, launches))
          + f" (expect {want}); auction rounds {rounds} ({rounds / n_steps:.1f} a step, "
          "7 matchings; K4's device counter)")
    if launches != want:
        fail("the train step did not launch the kernels as expected: "
             + ", ".join(f"{k} {n} of {w}" for k, n, w in zip(COUNTED, launches, want)))
    with sync_debug() as caught:
        step(state, batches[0], text_embed)
    if caught:
        fail(f"a replay of the train graph synchronises: {caught[0]}")
    torch.cuda.synchronize()
    print("  one replay under set_sync_debug_mode('error'): no synchronisation", flush=True)
    ms_step = statistics.median(times)
    print(f"  train step (CUDA graph replays): {', '.join(f'{t:.2f}' for t in times)} ms/step; "
          f"median {ms_step:.2f} ms/step = {BATCH * 1e3 / ms_step:.3f} img/s; "
          f"peak memory {peak_gb:.2f} GB allocated (a replay allocates nothing; the pool "
          f"{step.pool_bytes / 1e9:.3f} GB beside it), {reserved_gb:.2f} GB reserved",
          flush=True)
    graph_vs_eager(step, state, batches[0], text_embed)
    if against_eager != "one":
        two_runs(step, state, batches, text_embed)
    if list(step.graphs) != [g_key]:
        fail(f"the train step captured {len(step.graphs)} graphs for one batch shape")

    n_ops = {}
    dev = profile_once(lambda: step(state, batches[1], text_embed), also=ALL_OPS, counts=n_ops)
    seen = {k: n_ops.get(KERNELS[k][2], 0) for k in COUNTED}
    if phase is not None and "all" in dev:
        REPLAY_BUSY[phase] = dev["all"]
    print(f"  the replay's device operations: {n_ops.get('all')}; the kernels in its profile "
          f"{seen}; K4 {dev.get('auction_kernel', float('nan')):.4f} ms", flush=True)
    if phase is not None:
        n, ms = f32_gemms(lambda: step(state, batches[1], text_embed))
        F32_GEMMS[phase] = n
        print(f"  F-P10: f32 CUDA-core GEMMs (ffma/sgemm) in a replay: {n} launches, "
              f"{ms:.3f} ms", flush=True)
    # The graphs' pool is not needed past here: free it for the eager steps.
    step.reset()
    del metrics, m, graph
    free_memory()
    print(f"  the step's graphs dropped: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated",
          flush=True)

    # The gradient of one step with the kernels against the same step with the
    # plain versions in place of all of them, same weights, batch and draws.
    loss_fn = make_loss_fn(model, cfg, clip_model)
    draws = step_draws(cfg, BATCH, torch.Generator(device=DEVICE).manual_seed(7), device=DEVICE)
    params = dict(model.named_parameters())

    def grads():
        model.zero_grad(set_to_none=True)
        total, _ = loss_fn(batches[0], draws, text_embed)
        total.backward()
        out = {n: params[n].grad.float().clone() for n in leaves}
        model.zero_grad(set_to_none=True)
        return float(total.detach()), out

    loss_k, g_k = grads()
    with plain_versions():
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    print(f"  kernels vs plain versions, one step: loss {loss_k:.4f} vs {loss_p:.4f}")
    worst = 1.0
    for n in leaves:
        cos = float(torch.nn.functional.cosine_similarity(g_k[n].flatten(), g_p[n].flatten(), 0))
        worst = min(worst, cos)
        print(f"    grad cosine {cos:.5f}  {n}")
    # bf16 steps that round the other way in the kernels reorder some of the
    # 900 two-stage selections among near-tied random-weight scores (phase 6),
    # which moves the matching and the decoder's gradients; measured on an
    # H100: cosines 0.9896-0.9967 at this seed (phase 7)
    if worst < COS_MIN:
        fail(f"a gradient with the kernels departs from the plain one (cosine < {COS_MIN})")
    del g_k, g_p
    if cfg.use_language:  # F-P7's before and after, on one set of weights and draws
        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            loss_fn(batches[0], draws, text_embed)[0].backward()
            model.zero_grad(set_to_none=True)

        head_profiles(fwd_bwd, "loss forward and backward")

        def fwd_bwd_frozen():  # as the step's body: the FrozenBN buffers' gradients too
            for b in step.buffers:
                b.requires_grad_(True)
            try:
                fwd_bwd()
            finally:
                for b in step.buffers:
                    b.requires_grad_(False)
                    b.grad = None

        n_no, n_fb = {}, {}
        no = profile_once(fwd_bwd, top=3, also=ALL_OPS, counts=n_no)
        fb = profile_once(fwd_bwd_frozen, top=3, also=ALL_OPS, counts=n_fb)
        if "all" in no and "all" in fb:
            print(f"  the FrozenBN buffers' gradients, which the step's body takes for the norm: "
                  f"{n_fb['all'] - n_no['all']} operations and {fb['all'] - no['all']:.2f} ms "
                  f"of device time in an eager loss forward and backward ({n_fb['all']} "
                  f"operations, {fb['all']:.2f} ms, against {n_no['all']}, {no['all']:.2f} ms "
                  f"without them)", flush=True)
    return launches


def phase_train(recs):
    from richsem_tpu_torch.config import Config

    cfg = Config.fromfile(TRAIN_CONFIG)
    cfg.compute_dtype = "bfloat16"
    launches = run_train(cfg, (12, 12, 6, 6, 0, 0, 7, 1, 1), N_STEPS, GRAD_LEAVES)
    for rec, n in zip(recs, launches):
        rec["dino_train_launches"] = n
    print("phase 7: train step ok", flush=True)


def phase_flagship(recs):
    """The flagship train step (richsem_4scale_lvis.py) with a random-weight bf16
    RN50 teacher and a random 1204 x 1024 text bank, as bench.py:114-126 builds
    them; then the same step with the separable decoder sampler (K3). -> the
    cost matrices and masks of the first step's seven matchings."""
    import torch

    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models.build import build_clip_teacher
    from richsem_tpu_torch.models.clip_align import (clip_spatial_features,
                                                     clip_teacher_box_targets)

    cfg = Config.fromfile(CONFIG)
    cfg.compute_dtype = "bfloat16"
    g = torch.Generator(device=DEVICE).manual_seed(2)
    teacher = build_clip_teacher(cfg, dtype=torch.bfloat16, device=DEVICE, generator=g)
    text_embed = torch.randn((cfg.num_classes, 1024), generator=g, device=DEVICE)
    batch = train_batch(g)

    def targets():
        spatial = clip_spatial_features(teacher, batch["images"])
        return clip_teacher_box_targets(
            teacher, batch["images"], batch["boxes"], batch["size"].float(), text_embed,
            teacher.logit_scale, valid=batch["valid"], max_boxes=cfg.distill_max_boxes,
            spatial=spatial)

    emb, logits, cvalid = targets()
    if not (torch.isfinite(emb).all() and torch.isfinite(logits).all()):
        fail("the teacher's box targets are not finite")
    teacher_ms = cuda_ms(targets, iters=5, warmup=1)
    print(f"  teacher: spatial forward + RoIAlign + attention pool at {int(cvalid.sum())} "
          f"boxes {teacher_ms:.3f} ms (CUDA events), embeddings {tuple(emb.shape)}, "
          f"logits {tuple(logits.shape)}", flush=True)
    del emb, logits, cvalid
    profile_once(targets, top=6)

    costs = []
    launches = run_train(cfg, (12, 12, 6, 6, 0, 0, 7, 1, 1), N_STEPS, FLAGSHIP_LEAVES,
                         clip_model=teacher, text_embed=text_embed, costs=costs,
                         phase="phase 10")
    for rec, n in zip(recs[:4] + recs[6:], launches[:4] + launches[6:]):
        rec["launches"] = n
    print("phase 10: flagship train step ok", flush=True)
    torch.cuda.empty_cache()

    cfg.dec_msda_impl = "sep_pallas"
    launches = run_train(cfg, (6, 6, 6, 6, 6, 6, 7, 1, 1), N_SEP_STEPS, FLAGSHIP_LEAVES,
                         clip_model=teacher, text_embed=text_embed)
    for rec, n in zip(recs[4:6], launches[4:6]):
        rec["launches"] = n
    for rec, n in zip(recs, launches):
        rec["sep_pallas_launches"] = n
    print('phase 11: flagship train step with dec_msda_impl="sep_pallas" ok', flush=True)
    return costs


def auction_random(g, n_valid, spread=None):
    """K4's random case: B 2, P 300 GT slots with ``n_valid`` valid, O 900,
    costs from the generator ``g``; with ``spread``, each problem's rows are
    one random row plus ``spread`` times noise, so the valid persons want the
    same queries and evict each other for tens of rounds, a few bidders a
    round, as in a flagship matching."""
    import torch

    if spread is None:
        c = torch.randn((BATCH, MAX_GT, 900), generator=g, device=DEVICE)
    else:
        c = torch.randn((BATCH, 1, 900), generator=g, device=DEVICE)
        c = c + spread * torch.randn((BATCH, MAX_GT, 900), generator=g, device=DEVICE)
    v = (torch.arange(MAX_GT, device=DEVICE) < n_valid)[None].repeat(BATCH, 1)
    return c, v


AUCTION_SPREAD = 0.1  # the correlated case's noise: ~50 rounds at 16 valid


def auction_cases(costs):
    """K4's cases: the flagship step's matchings (``costs``), the correlated
    rows of ``auction_random`` at P 300 with 16 valid and O 900, random costs
    at P 300 with 16 and with 300 valid and O 900, P 20 with 17 valid at O 30
    (rows of 120 bytes, read without float4s), the price-war tied rows of
    ``tests/test_lap.py``, a cap of 3 that leaves the greedy fallback work to
    do, and a problem with no valid person. -> (name, cost, valid, max_iters)."""
    import torch

    cases = [(f"flagship matching {i} {tuple(c.shape)}", c, v, 3000)
             for i, (c, v) in enumerate(costs)]
    c, v = auction_random(torch.Generator(device=DEVICE).manual_seed(11), N_VALID, AUCTION_SPREAD)
    cases.append((f"correlated rows P {MAX_GT}, {N_VALID} valid, O 900", c, v, 3000))
    g = torch.Generator(device=DEVICE).manual_seed(11)
    for n in (N_VALID, MAX_GT):
        cases.append((f"random P {MAX_GT}, {n} valid, O 900", *auction_random(g, n), 3000))
    base = torch.randn((1, 200), generator=g, device=DEVICE)
    tied = base.repeat(40, 1) + 1e-5 * torch.randn((40, 200), generator=g, device=DEVICE)
    cases.append(("price-war tied rows P 40, O 200", tied[None],
                  torch.ones(1, 40, dtype=torch.bool, device=DEVICE), 3000))
    capped = torch.zeros(1, 20, 60, device=DEVICE)
    capped[:, :, 3::7] = -1.0
    cases.append(("cap 3, greedy fallback", capped, torch.arange(20, device=DEVICE)[None] < 17, 3))
    cases.append(("no valid person", torch.randn((1, 7, 30), generator=g, device=DEVICE),
                  torch.zeros(1, 7, dtype=torch.bool, device=DEVICE), 3000))
    cases.append(("P 20, 17 valid, O 30", torch.randn((1, 20, 30), generator=g, device=DEVICE),
                  torch.arange(20, device=DEVICE)[None] < 17, 3000))
    return cases


def phase_auction(rec, costs):
    """K4 against the plain ``_auction`` on the same CUDA tensors, exact: the
    assignment (``torch.equal``) and each problem's rounds (the plain loop run
    on that problem alone), on :func:`auction_cases`, with its device time a
    round (three profiled calls); then K4's device time (the mean of five profiled calls)
    and CUDA-event time beside the plain loop's host and device time, on the
    first flagship matching (or the correlated case), with the bound:
    the valid rows read once and the masks and outputs once, against the
    rounds' f32 operations (each bid's row: a subtraction, a comparison and a
    maximum an object; the scale's pass) at the CUDA cores' issue rate; and
    the latency a round."""
    import torch

    from richsem_tpu_torch.ops import lap

    t0 = time.perf_counter()
    cases = auction_cases(costs)
    for name, c, v, iters in cases:
        fn = lambda: lap._auction_cuda(c, v, True, iters, 1e-4)  # noqa: E731
        obj, stats = fn()
        ref, rounds = lap._auction(-c, v, iters, 1e-4)
        alone = [lap._auction(-c[i:i + 1], v[i:i + 1], iters, 1e-4)[1] for i in range(len(c))]
        torch.cuda.synchronize()
        got = stats[:, 0].tolist()
        same = torch.equal(obj, ref) and got == alone and max(got) == rounds
        held = obj[v]
        kern = device_ms(fn, ["auction_kernel"], iters=3)["auction_kernel"] if max(got) else None
        per_round = kern / max(got) * 1e3 if kern is not None and max(got) else None
        print(f"  K4 {name}: obj_of equal {torch.equal(obj, ref)}, rounds {got} (plain {alone}), "
              f"bids {stats[:, 1].tolist()}; {held.numel()} valid, {held.unique().numel()} "
              f"distinct objects; device {_ms(kern)} ms, {_ms(per_round)} us a round",
              flush=True)
        if not same:
            fail(f"K4 differs from the plain auction on {name}")
        if iters == 3 and held.unique().numel() == held.numel():
            fail("the capped case left the greedy fallback no collision to make")
    name, c, v, _ = cases[0]
    obj, stats = lap._auction_cuda(c, v, True, 3000, 1e-4)
    # a launch: one of five calls' kernels went unrecorded in each of three
    # profiles in one run (device_ms takes the mean over those recorded)
    n = {}
    dev = device_ms(lambda: lap._auction_cuda(c, v, True, 3000, 1e-4), ["auction_kernel"],
                    also=ALL_OPS, counts=n)
    kern = dev["auction_kernel"]
    ms = cuda_ms(lambda: lap._auction_cuda(c, v, True, 3000, 1e-4), iters=20)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        lap._auction(-c, v, 3000, 1e-4)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3 / 5
    plain_dev = device_ms(lambda: lap._auction(-c, v, 3000, 1e-4), [], iters=1,
                          also=ALL_OPS)["all"]
    rounds, bids = int(stats[:, 0].max()), int(stats[:, 1].sum())
    n_valid, (b, p, o) = int(v.sum()), c.shape
    read = n_valid * o * 4 + b * p + b * p * 8 + b * 2 * 4
    bms, by = bound(read, bids * o * 3 + n_valid * o * 2, F32_ISSUE_OPS)
    per_round = kern / rounds * 1e3 if kern is not None and rounds else None
    print(f"  K4 on {name}: device {_ms(kern)} ms a launch ({n.get('auction_kernel')} of 5 "
          f"recorded; the wrapper's {n.get('all')} operations in 5 calls, {_ms(dev['all'])} ms "
          f"a call), "
          f"CUDA events {ms:.4f} ms; plain loop: host {plain_ms:.3f} ms, device "
          f"{_ms(plain_dev)} ms; {rounds} rounds, {bids} bids; bound {bms:.6f} ms ({by}); "
          f"{_ms(per_round)} us a round (the rounds run one after another)", flush=True)
    rec.update({"max_abs_err": 0.0, "ms": ms, "device_ms": kern, "plain_ms": plain_ms,
                "plain_device_ms": plain_dev, "bound_ms": bms, "bound_by": by,
                "library_ms": None, "rounds": rounds, "bids": bids,
                "us_per_round": per_round, "case": name})
    print(f"phase 15: K4 equals the plain auction ({time.perf_counter() - t0:.1f} s)", flush=True)


ADAMW_SCALES = (1.0, 0.3, 1e-6)  # phase 16's gradient scales: the clip binds, binds, does not
NO_GRAD = 1  # phase 16's leaf without a gradient, a trainable one (K6's null path)
# f32 operations an element of K6 does, by order (the clip, the moments, the
# Adam term, the decay and the step; the group scale's product left out)
K6_OPS = {"chain": 18, "fused": 17}


def adamw_case():
    """Phase 16's inputs: the flagship model (``richsem_4scale_lvis.py``) from a
    seeded generator, AdamW over its leaves at their real shapes (338
    trainable; 224 frozen, the FrozenBN buffers among them, in the norm only),
    and a gradient set for each of ADAMW_SCALES drawn on the card, leaf
    NO_GRAD without one. -> (model, opt, leaves, gradient sets)."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train.optim import AdamW

    cfg = Config.fromfile(CONFIG)
    cfg.compute_dtype = "bfloat16"
    g = torch.Generator(device=DEVICE).manual_seed(16)
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    opt = AdamW(model, cfg, steps_per_epoch=1000)
    leaves = [t for _, t in opt.trainable + opt.frozen]
    sets = [[None if i == NO_GRAD else torch.randn(t.shape, generator=g, device=DEVICE) * s
             for i, t in enumerate(leaves)] for s in ADAMW_SCALES]
    return model, opt, leaves, sets


def opt_copy(opt):
    """A copy of what an update changes: the trainable leaves, the moments, the count."""
    return ([p.detach().clone() for _, p in opt.trainable], [t.clone() for t in opt.mu],
            [t.clone() for t in opt.nu], opt.count)


def opt_put(opt, saved) -> None:
    import torch

    with torch.no_grad():
        for dst, src in zip(([p for _, p in opt.trainable], opt.mu, opt.nu), saved[:3]):
            for a, b in zip(dst, src):
                a.copy_(b)
    opt.count = saved[3]


def k6_call(opt, grads, clip_state, order, plain=False):
    """-> a call of K6 (or its plain version) on ``opt``'s leaves and state."""
    from richsem_tpu_torch.ops import adamw

    fn = adamw.adamw_update_plain if plain else adamw.adamw_update
    n = len(opt.trainable)
    return lambda: fn([p for _, p in opt.trainable], grads[:n], opt.mu, opt.nu, opt.hyper,
                      clip_state, [opt.scales[k] for k, _ in opt.trainable], b1=opt.b1,
                      b2=opt.b2, eps=opt.eps, weight_decay=opt.weight_decay,
                      max_norm=opt.clip_max_norm, order=order)


@contextlib.contextmanager
def plain_optimizer():
    """The plain versions of K5 and K6 in place of the wrappers, where
    ``AdamW.update`` calls them."""
    from richsem_tpu_torch.ops import adamw
    from richsem_tpu_torch.train import optim

    optim.global_norm_clip, optim.adamw_update = (adamw.global_norm_clip_plain,
                                                  adamw.adamw_update_plain)
    try:
        yield
    finally:
        optim.global_norm_clip, optim.adamw_update = adamw.global_norm_clip, adamw.adamw_update


def adamw_steps(opt, leaves, sets):
    """One ``AdamW.step`` a gradient set. -> (the norms, ``opt_copy`` after)."""
    import torch

    gnorms = []
    for grads in sets:
        for t, gr in zip(leaves, grads):
            t.grad = gr
        gnorms.append(opt.step())
    torch.cuda.synchronize()
    opt.zero_grad()
    return [float(g) for g in gnorms], opt_copy(opt)


def phase_adamw(k5_rec, k6_rec):
    """Phase 16: K5 (the global norm) and K6 (the AdamW update) on the
    flagship's leaves (``adamw_case``): in both orders, three steps from one
    state (the clip binding, binding, not binding) against the plain
    versions, the parameters and moments bit for bit and the norms within one
    f32 step; K5 twice and K6 twice from one state, bit for bit; each
    kernel's device time a launch (``ms``, five profiled calls) beside its
    CUDA-event time a call (``event_ms``, the host's: each eager call builds
    the tables), the plain version's device time, the bound (bytes at 3.35
    TB/s: K5 reads every gradient, K6 reads g, m, v and p and writes m, v and
    p) and the share; and the device time of one library call each, as a
    scale of time, not a check: for K5 ``torch.nn.utils.get_total_norm`` over
    the same gradients (it sums in f32 and leaves the clip factor out), for K6
    ``torch._fused_adamw_``, one call a lr group (its decoupled decay rounds
    otherwise)."""
    import torch

    from richsem_tpu_torch.ops import adamw

    t0 = time.perf_counter()
    model, opt, leaves, sets = adamw_case()
    n_el = sum(t.numel() for t in leaves)
    n_tr = sum(p.numel() for _, p in opt.trainable)
    print(f"  the flagship's leaves: {len(opt.trainable)} trainable ({n_tr:,} elements), "
          f"{len(opt.frozen)} frozen ({n_el - n_tr:,}); leaf {NO_GRAD} without a gradient; "
          f"gradient scales {ADAMW_SCALES}", flush=True)
    saved = opt_copy(opt)
    counters = (adamw.global_norm_clip, adamw.adamw_update)
    gn_err, errs = 0.0, []
    for order in adamw.ORDERS:
        opt.order = order
        opt_put(opt, saved)
        before = [c.launches for c in counters]
        gk, sk = adamw_steps(opt, leaves, sets)
        launched = [c.launches - b for c, b in zip(counters, before)]
        opt_put(opt, saved)
        with plain_optimizer():
            gp, sp = adamw_steps(opt, leaves, sets)
        print(f"  {order}: norms K5 {', '.join(f'{g:.9g}' for g in gk)}, plain "
              f"{', '.join(f'{g:.9g}' for g in gp)}; launches K5 {launched[0]}, K6 {launched[1]}",
              flush=True)
        if launched != [len(sets)] * 2:
            fail(f"phase 16 launched K5 {launched[0]} and K6 {launched[1]} times in "
                 f"{len(sets)} steps")
        if not (gk[0] > opt.clip_max_norm > gk[-1]):
            fail(f"phase 16's norms {gk} do not bind the clip first and release it last")
        for a, b in zip(gk, gp):
            gn_err = max(gn_err, abs(a - b))
            if abs(a - b) > ulp(torch.tensor(b)):
                fail(f"K5's norm {a!r} lies more than one f32 step from the plain {b!r}")
        for what, i in (("parameters", 0), ("m", 1), ("v", 2)):
            errs.append(compare_exact(f"K5 + K6 {order}, 3 steps: {what}",
                                      torch.cat([t.flatten() for t in sk[i]]),
                                      torch.cat([t.flatten() for t in sp[i]])))
        if torch.equal(sk[0][0], saved[0][0]):
            fail("phase 16's steps left the parameters where they were")
        del sk, sp

    grads = sets[0]
    k5 = lambda: adamw.global_norm_clip(grads, opt.clip_max_norm)  # noqa: E731
    a, b = k5()[1].clone(), k5()[1].clone()
    torch.cuda.synchronize()
    print(f"  K5 twice: bit for bit {torch.equal(a, b)} (gnorm {float(a[0]):.9g}, clip "
          f"{float(a[1]):.9g})", flush=True)
    if not torch.equal(a, b):
        fail("two calls of K5 differ")
    opt.prepare()
    for order in adamw.ORDERS:
        ends = []
        for _ in range(2):
            opt_put(opt, saved)
            k6_call(opt, grads, a, order)()
            ends.append(opt_copy(opt))
        same = all(torch.equal(x, y) for i in range(3) for x, y in zip(ends[0][i], ends[1][i]))
        print(f"  K6 {order} twice from one state: bit for bit {same}", flush=True)
        if not same:
            fail(f"two calls of K6 ({order}) from one state differ")
        del ends

    # times, at the first gradient set (the clip binds): device time a launch
    # (device_ms), CUDA-event time a call, and the plain versions' and the
    # library calls' device time a call
    numels = [0 if g is None else g.numel() for g in grads]
    chunks = adamw.total_chunks(adamw.plan(numels, adamw.NORM_LEAVES))
    present = sum(numels)
    ev = cuda_ms(k5)
    dev = device_ms(k5, ["sumsq_kernel", "sumsq_finish_kernel"])
    kern = total_ms(dev)
    n_plain = {}
    plain_dev = device_ms(lambda: adamw.global_norm_clip_plain(grads, opt.clip_max_norm), [],
                          iters=2, also=ALL_OPS, counts=n_plain)["all"]
    given = [g for g in grads if g is not None]
    norm_library = lambda: torch.nn.utils.get_total_norm(given, 2.0, foreach=True)  # noqa: E731
    lib_ev = cuda_ms(norm_library)
    lib_dev = device_ms(norm_library, [], also=ALL_OPS)["all"]
    lib_norm = float(norm_library())
    # every gradient read once, the partials written and read, the state written;
    # a product and a float64 add an element
    bms, by = bound(4 * present + 16 * chunks + 8, 2 * present, F32_ISSUE_OPS)
    print(f"  K5: {chunks} blocks; device {_ms(dev['sumsq_kernel'])} + finish "
          f"{_ms(dev['sumsq_finish_kernel'])} ms a launch (CUDA events {ev:.4f} ms a call); "
          f"plain: device {_ms(plain_dev)} ms a call ({n_plain.get('all')} operations in 2); "
          f"bound {bms:.4f} ms ({by}), share {_ms(bms / kern if kern else None)}; "
          f"get_total_norm (a yardstick, f32 sums): device {_ms(lib_dev)} ms a call, CUDA "
          f"events {lib_ev:.4f} ms, norm {lib_norm:.9g} against K5's {float(a[0]):.9g}",
          flush=True)
    k5_rec.update({"max_abs_err": gn_err, "ms": kern, "event_ms": ev,
                   "sumsq_ms": dev["sumsq_kernel"], "finish_ms": dev["sumsq_finish_kernel"],
                   "plain_ms": plain_dev, "bound_ms": bms, "bound_by": by,
                   "library_ms": lib_dev, "library_event_ms": lib_ev,
                   "library": "torch.nn.utils.get_total_norm(foreach=True), f32 sums, "
                              "device time", "blocks": chunks})

    n = len(opt.trainable)
    with_grad = sum(numels[:n])
    k6_rec.update({"max_abs_err": max(errs)})
    for order in adamw.ORDERS:
        opt_put(opt, saved)
        fn = k6_call(opt, grads, a, order)
        ev = cuda_ms(fn)
        dev = device_ms(fn, ["adamw_kernel"])["adamw_kernel"]
        n_plain = {}
        plain_dev = device_ms(k6_call(opt, grads, a, order, plain=True), [], iters=2,
                              also=ALL_OPS, counts=n_plain)["all"]
        bms, by = bound(4 * with_grad + 24 * n_tr + 20, K6_OPS[order] * n_tr, F32_ISSUE_OPS)
        print(f"  K6 {order}: {adamw.total_chunks(adamw.plan(numels[:n], adamw.ADAMW_LEAVES))} "
              f"blocks; device {_ms(dev)} ms a launch (CUDA events {ev:.4f} ms a call); plain: "
              f"device {_ms(plain_dev)} ms a call ({n_plain.get('all')} operations in 2); bound "
              f"{bms:.4f} ms ({by}), share {_ms(bms / dev if dev else None)}", flush=True)
        key = "" if order == "chain" else "fused_"
        k6_rec.update({f"{key}ms": dev, f"{key}event_ms": ev, f"{key}plain_ms": plain_dev,
                       f"{key}bound_ms": bms, f"{key}bound_by": by})
    # the yardstick: torch._fused_adamw_ a lr group, on copies
    groups = {}
    for (name, p), g in zip(opt.trainable, grads[:n]):
        groups.setdefault(opt.scales[name], []).append(
            (p.detach().clone(), torch.zeros_like(p) if g is None else g, torch.zeros_like(p),
             torch.zeros_like(p), torch.zeros((), device=DEVICE)))

    def library():
        for s, items in groups.items():
            ps, gs, ms_, vs, steps = (list(x) for x in zip(*items))
            torch._fused_adamw_(ps, gs, ms_, vs, [], steps, lr=2e-4 * s, beta1=opt.b1,
                                beta2=opt.b2, weight_decay=opt.weight_decay, eps=opt.eps,
                                amsgrad=False, maximize=False)

    ev = cuda_ms(library)
    n_lib = {}
    lib_dev = device_ms(library, [], also=ALL_OPS, counts=n_lib)["all"]
    print(f"  torch._fused_adamw_, {len(groups)} lr groups (a yardstick): device "
          f"{_ms(lib_dev)} ms a call ({n_lib.get('all')} operations in 5), CUDA events "
          f"{ev:.4f} ms", flush=True)
    k6_rec.update({"library_ms": lib_dev, "library_event_ms": ev,
                   "library": "torch._fused_adamw_, one call a lr group, device time"})
    del groups, model, opt, leaves, sets, saved
    print(f"phase 16: K5 and K6 match their plain versions in both orders "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def compare_exact(name, kernel_out, plain_out):
    """The kernel and the plain version agree bit for bit; -> 0.0."""
    import torch

    a, b = kernel_out.float(), plain_out.float()
    if not torch.isfinite(a).all():
        fail(f"{name}: kernel output is not finite")
    err = float((a - b).abs().max())
    ok = bool(torch.equal(kernel_out, plain_out))
    print(f"  {name}: max_abs_err {err:.3e} (tolerance: exact) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def bound3(nbytes_: float, f32_ops: float = 0.0, bf16_ops: float = 0.0, bf16_mma: float = 0.0):
    """(bound_ms, bound_by) for work on the CUDA cores (f32 and bf16 elementwise
    operations, each rounded on its own, at the issue rate of its type) and on
    the tensor cores (bf16 products)."""
    t_ops = max(f32_ops / F32_ISSUE_OPS + bf16_ops / BF16_VEC_ISSUE_OPS,
                bf16_mma / BF16_FLOPS) * 1e3
    t_bytes = nbytes_ / HBM_BPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


MXU_SHAPES = ((768, 128), (768, 32), (96, 32), (96, 128))  # run_mxu's (k, d) in main()
# fma-P as main() runs it: (label, P, two_acc); fma-4-chunk is fma_chunk
FMA_CASES = (("fma-1", 1, False), ("fma-2", 2, False), ("fma-4", 4, False),
             ("fma-4-2acc", 4, True), ("fma-4-chunk", 4, False))


def mxu_cost(a, b, reps):
    """bound3's arguments for ``bench_cal.mxu(a, b, reps)``: a and b read once,
    the f32 output written once, the adds on the CUDA cores, the products on
    the tensor cores."""
    (k, s), d = a.shape, b.shape[1]
    return {"nbytes_": nbytes(a, b) + 4 * k * d, "bf16_ops": k * s * reps,
            "bf16_mma": 2 * k * s * d * reps}


def fma_cost(hy, hx, p):
    """bound3's arguments for fma-P: the P of 4 points of hy and hx that it
    reads, the f32 output written once, 2P - 1 operations an output."""
    elems = hy.shape[0] * hy.shape[1] * hy.shape[2] * hx.shape[2] * (hy.shape[3] // 4)
    return {"nbytes_": nbytes(hy, hx) * p // 4 + 4 * elems, "f32_ops": (2 * p - 1) * elems}


def uniform_draws(seed):
    """-> rand(*shape, lo, hi, dtype): uniform draws on the card from one
    generator seeded with ``seed`` (its ``generator`` attribute)."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0, dtype=torch.float32):
        return (torch.rand(shape, generator=g, device=DEVICE) * (hi - lo) + lo).to(dtype)

    rand.generator = g
    return rand


def vpu_inputs(rand, dt):
    """run_vpu's comparison inputs of dtype ``dt`` at its [ROWS, S]: x around
    the pass index, so the hat fires."""
    from richsem_tpu_torch.tools import bench_cal

    shape = (bench_cal.ROWS, bench_cal.S)
    return rand(*shape, lo=0, hi=8, dtype=dt), rand(*shape, lo=-0.5, hi=1.5, dtype=dt)


def vpu_cost(x, reps):
    """bound3's arguments for ``bench_cal.vpu(x, y, reps)``: x and y read and
    the output written once, 6 operations an element a pass in x's dtype."""
    import torch

    key = "f32_ops" if x.dtype == torch.float32 else "bf16_ops"
    return {"nbytes_": 3 * nbytes(x), key: 6 * x.numel() * reps}


def repeat_cost(x, wx=52, reps=256):
    """bound3's arguments for ``bench_cal.repeat(x, wx, reps)``: x read and
    the output written once; x + i once a source element and the
    accumulation once an output element, each pass, in x's dtype."""
    import torch

    key = "f32_ops" if x.dtype == torch.float32 else "bf16_ops"
    return {"nbytes_": nbytes(x) * (1 + wx), key: reps * x.numel() * (1 + wx)}


def cell_cost(yr, xr, aw, wins, reps):
    """bound3's arguments for ``bench_cell.cell``: the inputs read and the f32
    output written once; a pass, a row and a level: y + it per point, 5
    operations a point and y tap (sub, abs, mul, sub, max), the 4 products of
    a basis entry and their 3 sums; hx, 4 operations a point and x tap, once a
    row (it does not depend on the pass); the contraction on the tensor
    cores."""
    mk, p, d = yr.shape[0], yr.shape[1] // len(wins), wins[0].shape[1]
    win = sum(w.shape[2] * w.shape[3] for w in wins)
    hy_ops = sum(p * (1 + 5 * w.shape[2]) for w in wins)
    hx_ops = sum(p * 4 * w.shape[3] for w in wins)
    return {"nbytes_": nbytes(yr, xr, aw, *wins) + 4 * mk * d,
            "f32_ops": reps * mk * (hy_ops + (2 * p - 1) * win) + mk * hx_ops,
            "bf16_mma": reps * 2 * mk * d * win}


def probe_case(call, replaces, launches, kern, plain, check, cost, kernels, library=None,
               iters=20, plain_iters=3):
    """One probe call: the kernel against its plain version (``check`` is
    ``"exact"`` or a relative tolerance of the largest |plain|), CUDA-event times
    of both and of ``library`` (one PyTorch call computing the same function),
    the device time of the kernel (its ``__global__`` functions ``kernels``) and
    of every device operation of ``library``, each the mean of five profiled
    calls, and the bound from ``cost``, :func:`bound3`'s arguments for these
    inputs (bytes, f32 and bf16 elementwise operations, bf16 tensor-core
    operations); where the CUDA-core operations set it, the line also prints
    the same count at the published peaks, which count an FMA as two (half
    the operations at the issue rate). -> the call's record."""
    import torch

    out, ref = kern(), plain()
    torch.cuda.synchronize()
    err = (compare_exact(call, out, ref) if check == "exact"
           else compare_rel(call, out, ref, check))
    del out, ref
    ms = cuda_ms(kern, iters=iters)
    plain_ms = cuda_ms(plain, iters=plain_iters, warmup=1)
    library_ms = cuda_ms(library, iters=iters) if library is not None else None
    dev = measured_sum(device_ms(kern, kernels))
    lib_dev = device_ms(library, [], also=ALL_OPS)["all"] if library is not None else None
    bms, by = bound3(**cost)
    peak_ms = bound3(**{k: v / 2 if k in ("f32_ops", "bf16_ops") else v
                        for k, v in cost.items()})[0]
    peak = f"; {peak_ms:.4f} at the published peaks" if peak_ms != bms else ""
    lib = (f"; library {library_ms:.4f} ms by events, {_ms(lib_dev)} device"
           if library is not None else "")
    share = f"{bms / dev:.3f}" if dev else "not measured"
    print(f"  {call}: kernel {_ms(dev)} ms device, {ms:.4f} by events; plain {plain_ms:.4f}{lib}; "
          f"bound {bms:.4f} ms ({by}, at the issue rate{peak}), "
          f"share {share} by device time; launches on the main path {launches}", flush=True)
    return {"call": call, "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "device_ms": dev, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "library_device_ms": lib_dev}


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def probe_ranking(calls) -> None:
    """The round's order over the probe calls, by device time: first those
    slower than their one PyTorch call, the largest factor first; then the
    rest by launches x (device ms - bound ms)."""
    slower = sorted((c for c in calls if c["device_ms"] and c["library_device_ms"]
                     and c["device_ms"] > c["library_device_ms"]),
                    key=lambda c: -c["device_ms"] / c["library_device_ms"])
    rest = sorted((c for c in calls if c["device_ms"] and c not in slower),
                  key=lambda c: -c["launches"] * (c["device_ms"] - c["bound_ms"]))
    print("  ranking (device time): " + "; ".join(
        [f"{c['call']} {c['device_ms'] / c['library_device_ms']:.3f}x its call" for c in slower]
        + [f"{c['call']} {c['launches'] * (c['device_ms'] - c['bound_ms']):.2f} ms lost"
           for c in rest]), flush=True)


def probe_record(name, calls, headline):
    """A source's record: the ``headline`` call's numbers at the top, every
    call under ``calls``, launches summed over the source's kernels."""
    top = next(c for c in calls if c["call"] == headline)
    return {"name": name, "route": "cuda", "source": f"richsem_tpu_torch/csrc/{name}.cu",
            "replaces": top["replaces"], "launches": sum(c["launches"] for c in calls),
            "max_abs_err": max(c["max_abs_err"] for c in calls),
            **{k: top[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "headline": headline, "calls": calls}


def phase_probes():
    """The calibration probes (richsem_tpu_torch/tools, the TPU's tools/ probes):
    each module's main() at the JAX defaults, launches counted; then every
    kernel against its plain version, timed beside its bound. -> 3 records."""
    import torch

    from richsem_tpu_torch.tools import bench_cal, bench_cell, bench_vpu_model

    wrappers = {"vpu": bench_cal.vpu, "mxu": bench_cal.mxu,
                "grid_overhead": bench_cal.grid_overhead, "repeat": bench_cal.repeat,
                "cell": bench_cell.cell, "tile": bench_cell.tile,
                "chain": bench_vpu_model.chain, "fma": bench_vpu_model.fma,
                "fma_chunk": bench_vpu_model.fma_chunk}
    # each run_* is a warm-up and then the timed calls: 2 + 20 (cal), 2 + 10
    # (cell), 1 + 30 (vpu_model); tile once
    want = {"vpu": 2 * 22, "mxu": 4 * 22, "grid_overhead": 2 * 22, "repeat": 2 * 22,
            "cell": 2 * 12, "tile": 1, "chain": 4 * 31, "fma": 4 * 31, "fma_chunk": 31}
    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    bench_cal.main(DEVICE)
    bench_cell.main(DEVICE)
    bench_vpu_model.main(DEVICE)
    torch.cuda.synchronize()
    n = {k: w.launches for k, w in wrappers.items()}
    print(f"  the probes' main() at the JAX defaults: {time.perf_counter() - t0:.1f} s; launches "
          + ", ".join(f"{k} {v}" for k, v in n.items()) + f" (expect {want})", flush=True)
    if n != want:
        fail("the probes' entry points did not launch their kernels as expected")

    rand = uniform_draws(12)
    g = rand.generator
    rows, s = bench_cal.ROWS, bench_cal.S
    cal = []
    for dt in (torch.float32, torch.bfloat16):
        x, y = vpu_inputs(rand, dt)
        cal.append(probe_case(
            f"run_vpu({str(dt)[6:]}, reps=512)", "tools/bench_pallas_cal.py:55",
            n["vpu"] // 2, lambda: bench_cal.vpu(x, y, 512), lambda: bench_cal.vpu_plain(x, y, 512),
            "exact", vpu_cost(x, 512),
            ["vpu_f32_kernel" if dt == torch.float32 else "vpu_bf16_kernel"]))
    steps = torch.arange(512, device=DEVICE).to(torch.bfloat16)  # bf16(i), as _step
    for k, d in MXU_SHAPES:
        a = torch.randn((k, s), generator=g, device=DEVICE).to(torch.bfloat16)
        b = torch.randn((s, d), generator=g, device=DEVICE).to(torch.bfloat16)
        # f32 sums of exact bf16 products, in another order
        cal.append(probe_case(
            f"run_mxu({k}, {s}, {d}, bfloat16, reps=512)", "tools/bench_pallas_cal.py:80",
            n["mxu"] // 4, lambda: bench_cal.mxu(a, b, 512), lambda: bench_cal.mxu_plain(a, b, 512),
            1e-5, mxu_cost(a, b, 512), MXU_KERNELS))
        if not torch.equal(bench_cal.mxu(a, b, 512), bench_cal.mxu(a, b, 512)):
            fail(f"run_mxu({k}, {s}, {d}): two calls differ (the partials' sum must be in a "
                 "fixed order)")
        # gemm_ms, a yardstick of the same tensor-core work (another function, so
        # not the library column): one bf16 matmul [k, 512 s] x [512 s, d] of the
        # operands concatenated outside the timed call
        a_cat = (a[:, None, :] + steps[None, :, None]).reshape(k, 512 * s)
        b_cat = b.repeat(512, 1)
        cal[-1]["gemm_ms"] = device_ms(lambda: a_cat @ b_cat, [], also=ALL_OPS)["all"]
        print(f"  gemm_ms (one torch.matmul [{k}, {512 * s}] x [{512 * s}, {d}], device): "
              f"{_ms(cal[-1]['gemm_ms'])}", flush=True)
        del a_cat, b_cat
    # the packed add alone, exact: b = I, so out = sum_i bf16(a + bf16(i)); a a
    # multiple of 2^-5 in [-8, 8], so a + i rounds (ties among them) above 8
    # and the f32 sums of four such values are exact; 96 rows (a masked half
    # tile) and s = 32 (a chunk half past s)
    a = (torch.randint(0, 513, (96, 32), generator=g, device=DEVICE) / 32 - 8).to(torch.bfloat16)
    eye = torch.eye(32, device=DEVICE, dtype=torch.bfloat16)
    cal.append(probe_case(
        "mxu(96, 32, 32, reps=4) with b = I: the packed add", "tools/bench_pallas_cal.py:80", 0,
        lambda: bench_cal.mxu(a, eye, 4), lambda: bench_cal.mxu_plain(a, eye, 4), "exact",
        mxu_cost(a, eye, 4), MXU_KERNELS))
    for cells in (4096, 16384):
        x = rand(cells, 8, 128, lo=-1, hi=1)
        cal.append(probe_case(
            f"run_grid_overhead({cells})", "tools/bench_pallas_cal.py:96", n["grid_overhead"] // 2,
            lambda: bench_cal.grid_overhead(x), lambda: bench_cal.grid_overhead_plain(x), "exact",
            {"nbytes_": 2 * nbytes(x), "f32_ops": x.numel()}, ["grid_kernel"],
            library=lambda: x * 2, iters=50, plain_iters=20))
        print(f"  kernel time a block at {cells} blocks: {cal[-1]['ms'] / cells * 1e6:.2f} ns "
              f"(kernel ms / blocks; the kernel streams 8 KB a block, so this is memory "
              f"time, not the cost of scheduling a block)")
    for dt in (torch.float32, torch.bfloat16):
        x = rand(rows, 32, lo=-2, hi=2, dtype=dt)
        cal.append(probe_case(
            f"run_repeat({str(dt)[6:]})", "tools/bench_pallas_cal.py:117", n["repeat"] // 2,
            lambda: bench_cal.repeat(x, 52, 256), lambda: bench_cal.repeat_plain(x, 52, 256),
            "exact", repeat_cost(x), [REPEAT_KERNELS[str(dt)[6:]]]))

    (yr, xr, aw), wins = bench_cell.cell_inputs(DEVICE)
    cells = []
    for mode in ("2d", "flat"):  # one function, one kernel: both lines time it
        # the kernel builds the plain version's bf16 basis bit for bit, so only
        # the f32 order of the contraction's sums differs (6.0e-5 of 31.5 on
        # the H100): a basis rounded otherwise is off by ~4e-3 and fails
        cells.append(probe_case(
            f"run_cell({mode!r}, reps=64)", "tools/bench_cell.py:102", n["cell"] // 2,
            lambda: bench_cell.cell(yr, xr, aw, wins, 64),
            lambda: bench_cell.cell_plain(yr, xr, aw, wins, 64), 1e-5,
            cell_cost(yr, xr, aw, wins, 64), CELL_KERNELS, iters=10, plain_iters=1))
    if not torch.equal(bench_cell.cell(yr, xr, aw, wins, 64), bench_cell.cell(yr, xr, aw, wins, 64)):
        fail("run_cell: two calls differ (the partials' sum must be in a fixed order)")
    print("  run_cell: two calls agree bit for bit", flush=True)
    x = torch.arange(8, dtype=torch.float32, device=DEVICE)[None].repeat(8, 1)
    cells.append(probe_case(
        "check_repeat_semantics()", "tools/bench_cell.py:121", n["tile"],
        lambda: bench_cell.tile(x, 2), lambda: bench_cell.tile_plain(x, 2), "exact",
        {"nbytes_": nbytes(x) * 3}, ["tile_kernel"], library=lambda: x.repeat(1, 2)))
    del yr, xr, aw, wins

    vm = []
    big = (bench_vpu_model.T, bench_vpu_model.M, bench_vpu_model.WY, bench_vpu_model.WXP,
           bench_vpu_model.K)
    kk = bench_vpu_model.K
    x = torch.randn(big, generator=g, device=DEVICE)
    # chain-1 and chain-2 are one rounding each, as x + x and x * 3 (2x is exact)
    libs = {1: lambda: x + x, 2: lambda: x * 3}
    for n_ops in (1, 2, 4, 8):
        vm.append(probe_case(
            f"chain-{n_ops}", "tools/bench_vpu_model.py:54", n["chain"] // 4,
            lambda: bench_vpu_model.chain(x, n_ops), lambda: bench_vpu_model.chain_plain(x, n_ops),
            "exact", {"nbytes_": 2 * nbytes(x), "f32_ops": n_ops * x.numel()}, ["chain_kernel"],
            library=libs.get(n_ops), iters=10, plain_iters=3))
    del x, libs
    hy = torch.randn(big[:3] + (4 * kk,), generator=g, device=DEVICE)
    hx = torch.randn(big[:2] + (big[3], 4 * kk), generator=g, device=DEVICE)
    hy_p, hx_p = hy.view(*big[:3], 4, kk), hx.view(*big[:2], big[3], 4, kk)

    def library_fma(p):
        """One PyTorch call: fma-1 is a broadcast product (bit for bit), fma-P a
        sum over the points by einsum (in another order)."""
        if p == 1:
            return lambda: hy[:, :, :, None, :kk] * hx[:, :, None, :, :kk]
        return lambda: torch.einsum("tmypk,tmxpk->tmyxk", hy_p[:, :, :, :p], hx_p[:, :, :, :p])

    for label, p, two in FMA_CASES[:-1]:
        vm.append(probe_case(
            label, "tools/bench_vpu_model.py:62", n["fma"] // 4,
            lambda: bench_vpu_model.fma(hy, hx, p, two),
            lambda: bench_vpu_model.fma_plain(hy, hx, p, two), "exact", fma_cost(hy, hx, p),
            ["fma_kernel"], library=library_fma(p), iters=10, plain_iters=3))
    vm.append(probe_case(
        "fma-4-chunk", "tools/bench_vpu_model.py:77", n["fma_chunk"],
        lambda: bench_vpu_model.fma_chunk(hy, hx, 4),
        lambda: bench_vpu_model.fma_chunk_plain(hy, hx, 4), "exact", fma_cost(hy, hx, 4),
        ["fma_kernel"], library=library_fma(4), iters=10, plain_iters=3))
    del hy, hx, hy_p, hx_p
    torch.cuda.empty_cache()
    probe_ranking(cal + cells + vm)
    print(f"phase 12: the probes match their plain versions ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return [probe_record("probe_cal", cal, "run_grid_overhead(16384)"),
            probe_record("probe_cell", cells, "run_cell('2d', reps=64)"),
            probe_record("probe_vpu_model", vm, "chain-1")]


def same_state(a: dict, b: dict) -> bool:
    """Two ``state_to_dict``s (or ``state_copy``s) equal bit for bit, leaf for leaf."""
    import torch

    def leaves(d, prefix=""):
        items = enumerate(d) if isinstance(d, list) else (d or {}).items()
        for k, v in items:
            yield from (leaves(v, f"{prefix}{k}.") if isinstance(v, (dict, list))
                        else [(f"{prefix}{k}", v)])

    a, b = dict(leaves(a)), dict(leaves(b))
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k] for k in a)


def trainer_graphs(run, cfg, ckpt_dir, saved):
    """Phase 13's train graphs, after the first run: the keys the trainer
    captured (one a canvas bucket) with each one's warm-up and capture ms and
    the pool; then, with those graphs live, one more step moves the state,
    the run's checkpoint restored into that state in place must equal the
    saved state bit for bit, and a replay from it is held against the eager
    body (``graph_vs_eager``)."""
    from richsem_tpu_torch.train import main as trainer
    from richsem_tpu_torch.utils.checkpoint import CheckpointManager, state_to_dict

    step, state = run["train_step"], run["state"]
    caps = [g.capture_ms for g in step.graphs.values()]
    print(f"  the trainer's train graphs: {len(caps)} keys (canvas buckets), warm-up + capture "
          f"{', '.join(f'{c:.1f}' for c in caps)} ms, pool {step.pool_bytes / 1e9:.3f} GB",
          flush=True)
    if not caps:
        fail("the trainer captured no train graph")
    host = next(iter(trainer.build_loaders(cfg)[0].epoch(0)))
    batch = trainer.place_batch(host, DEVICE)
    fed_weight = next(iter(step.graphs.values())).inputs.get("fed_weight")
    if fed_weight is not None:  # the trainer's, as it hands it to every step
        batch["fed_weight"] = fed_weight.clone()
    step(state, batch)  # past the checkpoint; a replay (the epoch's first bucket)
    CheckpointManager(ckpt_dir).restore(state, step=saved["step"])
    same = same_state(saved, state_to_dict(state))
    print(f"  checkpoint restored in place with the graphs live equals the saved state bit for "
          f"bit: {same}", flush=True)
    if not same:
        fail("the checkpoint restored under live graphs differs from the saved state")
    graph_vs_eager(step, state, batch, what="trainer")


def phase_trainer(recs):
    """Phase 13: ``dino_4scale_lvis.py`` trained through the port's entry point
    (``richsem_tpu_torch/train/main.py``) on a synthetic LVIS directory at full
    width, bf16, bs2: one epoch (steps, an eval, a checkpoint), then the same
    command with ``epochs=2`` (auto-resume, one more epoch), then ``--eval``
    through the CLI in a subprocess."""
    import shutil
    import tempfile

    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.data.synthetic import write_lvis
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train import main as trainer
    from richsem_tpu_torch.train.engine import create_train_state
    from richsem_tpu_torch.train.optim import build_optimizer
    from richsem_tpu_torch.utils.checkpoint import CheckpointManager, state_to_dict

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        t0 = time.perf_counter()
        root = write_lvis(os.path.join(tmp, "lvis"))
        print(f"  synthetic LVIS: 16 train and 4 val PNGs, 1203 categories, written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out = os.path.join(tmp, "out")
        common = ["-c", TRAIN_CONFIG, "--output_dir", out, "--data_root", root]

        def cfg_for(epochs):
            args = common + ["--device", DEVICE, "--options", f"epochs={epochs}"]
            return trainer.load_config(trainer.get_args_parser().parse_args(args))

        cfg = cfg_for(1)
        if (cfg.compute_dtype, cfg.batch_size) != ("bfloat16", 2):
            fail(f"phase 13 expects bf16 and bs2, got {cfg.compute_dtype} and {cfg.batch_size}")
        eval_batches = trainer.build_loaders(cfg)[1].num_batches_hint(0)
        counters = launch_counters()
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for epochs in (1, 2):
            t = time.perf_counter()
            runs.append(trainer.train_loop(cfg_for(epochs)))
            torch.cuda.synchronize()
            print(f"  train_loop(epochs={epochs}): {time.perf_counter() - t:.1f} s, step "
                  f"{runs[-1]['state'].step}", flush=True)
            if epochs == 1:
                launches = [c.launches for c in counters]
                saved = state_to_dict(runs[0]["state"])
                trainer_graphs(runs[0], cfg, os.path.join(out, "ckpt"), saved)
                del runs[0]["train_step"]  # its graphs' pool
                torch.cuda.empty_cache()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps1 = saved["step"]
        steps2 = runs[1]["state"].step - steps1
        if not runs[1]["ckpt_restore_s"] or [e["epoch"] for e in runs[1]["epochs"]] != [1]:
            fail("the second run did not auto-resume and take one more epoch")
        logs = [json.loads(line) for line in open(os.path.join(out, "log.txt"))]
        # the eval's forwards: a replay a batch, and a warm-up before each capture
        forwards = eval_batches + logs[0]["eval_graphs"]
        want = [12 * (steps1 + forwards), 12 * steps1, 6 * (steps1 + forwards), 6 * steps1, 0, 0,
                7 * steps1, steps1, steps1]
        print(f"  first run: {steps1} steps and {eval_batches} eval batches in "
              f"{logs[0]['eval_graphs']} graphs; launches "
              + ", ".join(f"{k} {n}" for k, n in zip(COUNTED, launches))
              + f" (expect {want}: 12/12/6/6/7/1/1 a step, K1 12 and K2 6 an eval forward)")
        if launches != want:
            fail("the trainer did not launch the kernels as expected")
        for rec, n in zip(recs, launches):
            rec["trainer_launches"] = n
        for e in logs:
            print(f"  log.txt epoch {e['epoch']}: step {e['step']}, loss {e['loss']:.4f}, "
                  f"AP {e['AP']:.4f}, APr {e['APr']:.4f}, eval {e['eval_ms_per_batch']:.1f} "
                  f"ms/batch, train_time_s {e['train_time_s']}")
        if [e["epoch"] for e in logs] != [0, 1] or not all(
                math.isfinite(e["loss"]) and 0.0 <= e["AP"] <= 1.0 for e in logs):
            fail("log.txt lacks two epochs with finite loss and AP in [0, 1]")

        # the checkpoint of the first run, restored into a state built afresh
        model, _, _ = build_model("richsem", cfg, device=DEVICE,
                                  generator=torch.Generator(device=DEVICE).manual_seed(7))
        fresh = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1),
                                   use_ema=cfg.use_ema)
        CheckpointManager(os.path.join(out, "ckpt")).restore(fresh, step=steps1)
        back = state_to_dict(fresh)
        same = same_state(saved, back)
        print(f"  restored state equals the saved one bit for bit: {same}")
        if not same:
            fail("the restored state differs from the saved one")
        del model, fresh, back, saved, runs[0]["state"]

        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "richsem_tpu_torch.train.main", *common, "--eval",
             "--device", DEVICE],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            fail("python -m richsem_tpu_torch.train.main --eval failed")
        ev = json.load(open(os.path.join(out, "eval.json")))
        print(f"  CLI --eval ({time.perf_counter() - t:.1f} s with start-up): step {ev['step']}, "
              f"AP {ev['AP']:.4f}, AP50 {ev['AP50']:.4f}, {ev['eval_ms_per_batch']:.1f} ms/batch")
        if ev["step"] != steps1 + steps2 or not 0.0 <= ev["AP"] <= 1.0:
            fail("--eval did not evaluate the last checkpoint to an AP in [0, 1]")

        step_ms = [1e3 * s for r in runs for s in r["step_s"]]
        wait_ms = [1e3 * s for r in runs for s in r["data_s"]]
        steady = [1e3 * s for r in runs for s in r["step_s"][1:]]
        save_s = [s for r in runs for s in r["ckpt_save_s"]]
        print(f"  train steps ({steps1} + {steps2}): {', '.join(f'{t:.1f}' for t in step_ms)} ms "
              f"(host clock, loader wait included); median {statistics.median(steady):.2f} ms/step "
              f"without each run's first step = {BATCH * 1e3 / statistics.median(steady):.3f} "
              f"img/s")
        print(f"  loader wait a step: median {statistics.median(wait_ms):.2f} ms, max "
              f"{max(wait_ms):.2f} ms; eval {logs[0]['eval_ms_per_batch']:.1f} and "
              f"{logs[1]['eval_ms_per_batch']:.1f} ms/batch; checkpoint save "
              f"{', '.join(f'{s:.2f}' for s in save_s)} s, restore "
              f"{runs[1]['ckpt_restore_s'][0]:.2f} s; peak memory {peak_gb:.2f} GB", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 13: the trainer trains, evaluates, checkpoints and resumes through "
          "train/main.py", flush=True)


BENCH_LAUNCHES = {  # the bench lines' launches a step or batch
    "train": {"K1": 12, "K1-bwd": 12, "K2": 6, "K2-bwd": 6, "K3": 0, "K3-bwd": 0, "K4": 7,
              "K5": 1, "K6": 1, "K7": 0},
    "eval": {"K1": 12, "K1-bwd": 0, "K2": 6, "K2-bwd": 0, "K3": 0, "K3-bwd": 0, "K4": 0,
             "K5": 0, "K6": 0, "K7": 0}}
PIPELINE_IMAGES = 100  # the input-pipeline bench's corpus here


def phase_bench():
    """Phase 14: the port's three benches in this process, at their defaults: the
    flagship train step (``richsem_tpu_torch/bench.py``), the eval step at its
    single point (``tools/bench_eval.py``) and the host input pipeline at 100
    images (``tools/bench_input_pipeline.py``: the JAX tool's corpus as JPEG at
    quality 90, read by the port's codec; the train bench's img/s as its chip
    rate; the codec's decode ms an image on one thread). Each JSON line is
    printed and its fields checked."""
    import torch

    from richsem_tpu_torch import bench
    from richsem_tpu_torch.tools import bench_eval, bench_input_pipeline

    lines = {}
    for name, run in (("train", lambda: bench.bench_line(env={})),
                      ("train fused", lambda: bench.bench_line(env={"BENCH_FUSED_OPT": "1"})),
                      ("eval", bench_eval.bench_line)):
        t = time.perf_counter()
        line = lines[name] = run()
        print(json.dumps(line), flush=True)
        kind = name.split()[0]
        unit = "step" if kind == "train" else "batch"
        times = [line[f"ms_per_{unit}_{k}"] for k in ("min", "median", "max")]
        print(f"  {name} bench: {time.perf_counter() - t:.1f} s", flush=True)
        if not (line["value"] > 0 and times == sorted(times) and line["card"]
                and line["warmup"] >= (3 if kind == "train" else 5)
                and line["timed"] >= (20 if kind == "train" else 30)
                and 0.0 <= line["idle_share"] <= 1.0 and line["device_busy_ms"] > 0
                and line["device_ops"] > 0 and line["peak_memory_gb"] > 0):
            fail(f"the {name} bench line lacks a field or holds a value out of range")
        if line[f"launches_per_{unit}"] != BENCH_LAUNCHES[kind]:
            fail(f"the {name} bench launched {line[f'launches_per_{unit}']}, not "
                 f"{BENCH_LAUNCHES[kind]}")
        if kind == "train" and ("fused AdamW" in line["metric"]) != (name == "train fused"):
            fail(f"the {name} bench line does not say which AdamW order it ran")
        if kind == "train" and not (line["auction_rounds_per_step"] > 0
                                    and line["auction_device_ms"] > 0):
            fail("the train bench line lacks the auction's rounds or K4's device ms")
        if not (line["graph"] and line["capture_ms"] > 0 and line["pool_gb"] > 0):
            fail(f"the {name} bench line did not replay a captured graph")
        torch.cuda.empty_cache()
    t = time.perf_counter()
    line = bench_input_pipeline.bench_line(PIPELINE_IMAGES, chip_rate=lines["train"]["value"])
    print(json.dumps(line), flush=True)
    print(f"  input pipeline bench: {time.perf_counter() - t:.1f} s", flush=True)
    if not (line["value"] > 0 and line["images"] > 0 and line["ratio_to_chip"] > 0
            and line["decode_ms"] > 0 and "JPEG corpus" in line["metric"]):
        fail("the input-pipeline bench line holds a value out of range, or did not read JPEG")
    print(f"  input pipeline on the JPEG corpus (quality 90): {line['value']:.2f} img/s on "
          f"{line['threads']} threads, ratio_to_chip {line['ratio_to_chip']:.3f} against this "
          f"run's train line ({lines['train']['value']:.3f} img/s); the codec decodes "
          f"{line['decode_ms']:.3f} ms an image on one host thread", flush=True)
    print("phase 14: the train, eval and input-pipeline benches ran", flush=True)


SWIN = "swin_L_384_22k"  # phase 18's backbone: embed 192, depths (2, 2, 18, 2), window 12
ALT_BACKBONES = ("convnext_xlarge_22k", "focalnet_L_384_22k")  # phase 19's
# backbone leaves whose gradients phase 18 compares with the plain versions'
SWIN_LEAVES = ("backbone.patch_embed.weight", "backbone.stage0_block0.attn.qkv.weight",
               "backbone.stage2_block5.attn.rel_pos_bias",
               "backbone.stage2_block17.mlp_fc2.weight", "backbone.merge_reduce2.weight",
               "backbone.out_norm3.weight") + FLAGSHIP_LEAVES[:2]
# K1's and K2's forward launches a train step with each memory knob (phase 20):
# use_checkpoint runs every layer's forward again, enc_selective_remat the
# encoder layers' around a kept K1 output, backbone_remat the ResNet only
KNOB_LAUNCHES = {None: (12, 6), "use_checkpoint": (24, 12), "enc_selective_remat": (12, 12),
                 "backbone_remat": (12, 6)}
BENCH_BATCHES = (4, 8)  # phase 20's train lines, with the root bench's remat knobs


def flagship_cfg(**overrides):
    """The flagship config in bf16 with ``overrides``."""
    from richsem_tpu_torch.config import Config

    cfg = Config.fromfile(CONFIG)
    cfg.compute_dtype = "bfloat16"
    cfg.update(overrides)
    return cfg


def teacher_and_text(cfg):
    """Phase 10's random-weight bf16 RN50 teacher and 1204 x 1024 text bank (seed 2)."""
    import torch

    from richsem_tpu_torch.models.build import build_clip_teacher

    g = torch.Generator(device=DEVICE).manual_seed(2)
    teacher = build_clip_teacher(cfg, dtype=torch.bfloat16, device=DEVICE, generator=g)
    return teacher, torch.randn((cfg.num_classes, 1024), generator=g, device=DEVICE), g


def check_eval_out(r, cfg):
    import torch

    if r["scores"].shape != (BATCH, cfg.num_select) or r["boxes"].shape != (
            BATCH, cfg.num_select, 4):
        fail(f"eval output shapes {tuple(r['scores'].shape)} {tuple(r['boxes'].shape)}")
    if not all(torch.isfinite(r[k].float()).all() for k in ("scores", "boxes")):
        fail("eval outputs are not finite")


def phase_swin(recs):
    """Phase 18: the flagship with the Swin-L backbone (``swin_L_384_22k``) at
    full width, bf16, bs2 on 896 x 1344: the eval graph (3 replays, the replay
    against the eager body bit for bit, K1 and K2 launches, ms/batch, peak GB),
    then the train graph as phase 10 (``run_train``: 5 replays, launches, the
    replay against one eager step, gradients against the plain versions, a
    profiled replay and its f32 CUDA-core GEMMs)."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.train.engine import eval_forward, make_eval_step

    free_memory()
    print(f"  at the start: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    t0 = time.perf_counter()
    cfg = flagship_cfg(backbone=SWIN)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    n_bb = sum(p.numel() for n, p in model.named_parameters() if n.startswith("backbone."))
    text_embed = torch.randn((cfg.num_classes, 1024), generator=g, device=DEVICE)
    batches = [eval_batch(g, CANVAS) for _ in range(N_BATCHES + 1)]
    step = make_eval_step(model, cfg)
    step(batches[-1], text_embed)  # warm-up and capture
    torch.cuda.synchronize()
    print(f"  {SWIN}: backbone {n_bb / 1e6:.1f} M parameters; eval setup + warm-up + capture "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    k1.ms_deform_attn.launches = k2.encoder_tail.launches = 0
    times, results = [], []
    for batch in batches[:N_BATCHES]:
        t = time.perf_counter()
        results.append(step(batch, text_embed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    n_k1, n_k2 = k1.ms_deform_attn.launches, k2.encoder_tail.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in results:
        check_eval_out(r, cfg)
    want = ((cfg.enc_layers + cfg.dec_layers) * N_BATCHES, cfg.enc_layers * N_BATCHES)
    ms_batch = statistics.median(times)
    print(f"  eval (CUDA graph replays): {', '.join(f'{t:.2f}' for t in times)} ms/batch; median "
          f"{ms_batch:.2f} ms/batch = {BATCH * 1e3 / ms_batch:.3f} img/s; peak memory "
          f"{peak_gb:.2f} GB allocated, the graph's pool {step.pool_bytes / 1e9:.3f} GB beside "
          f"it; launches K1 {n_k1}, K2 {n_k2} (expect {want[0]}, {want[1]})", flush=True)
    if (n_k1, n_k2) != want:
        fail("the Swin-L eval path did not launch K1 12 and K2 6 times a forward")
    graphed = step(batches[0], text_embed)
    with torch.inference_mode():
        eager = eval_forward(model, cfg, batches[0], text_embed)
    torch.cuda.synchronize()
    same = all(torch.equal(graphed[k], eager[k]) for k in ("scores", "labels", "boxes"))
    print(f"  eval replay equals the eager body bit for bit: {same}", flush=True)
    if not same:
        fail("the Swin-L eval graph differs from its eager body")
    for rec, n in zip(recs[:3:2], (n_k1, n_k2)):
        rec["swin_eval_launches"] = n
    del step, results, graphed, eager
    backbone_profiles(model, batches[0]["images"])
    del model
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    print(f"  eval part {t1 - t0:.1f} s", flush=True)

    teacher, text_embed, _ = teacher_and_text(cfg)
    launches = run_train(cfg, (12, 12, 6, 6, 0, 0, 7, None, None), N_STEPS, SWIN_LEAVES,
                         clip_model=teacher, text_embed=text_embed, phase="phase 18",
                         against_eager="one")
    for rec, n in zip(recs, launches):
        rec["swin_launches"] = n
    print(f"  F-P10: f32 CUDA-core GEMMs a replay, Swin-L {F32_GEMMS.get('phase 18')} against "
          f"the R50 flagship's {F32_GEMMS.get('phase 10', 'not measured')}", flush=True)
    print(f"  train part {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"phase 18: Swin-L flagship eval and train graphs ok ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    torch.cuda.empty_cache()


def backbone_profiles(model, images):
    """Where the backbone's time goes: its eager forward (inference) and its
    forward and backward (the sum of its outputs) profiled once each, with
    the busy ms, the operations, the busiest kernels and the GELU's kernels
    (``F.gelu``, one pass each way)."""
    import torch

    from richsem_tpu_torch.utils.profiling import profile_call

    images = images.to(model.cfg.compute_dtype)

    def forward():
        with torch.inference_mode():
            model.backbone(images)

    def forward_backward():
        sum(f.float().sum() for f in model.backbone(images)).backward()
        model.zero_grad(set_to_none=True)

    for what, fn in (("forward", forward), ("forward and backward", forward_backward)):
        fn()  # warm-up
        prof = profile_call(fn)
        if prof is None:
            print(f"  backbone {what}: no device time recorded (not measured)")
            continue
        print(f"  backbone {what} (eager): busy {prof.busy_ms:.2f} ms, {prof.n_ops} operations, "
              f"idle share {prof.idle_share:.3f}; busiest:", flush=True)
        for key, n, ms in sorted(prof.ops, key=lambda o: -o[2])[:8]:
            print(f"    {ms:9.3f} ms  x{n:<5d} {key[:100]}")
        n, ms = prof.matching("Gelu") or (0, 0.0)
        print(f"    the GELU: {ms:.3f} ms over {n} kernels", flush=True)


def eager_step(cfg, teacher, text_embed, batch, draws=None, grads=False):
    """Build the detector of ``cfg`` from seed 0 and take one eager train step
    (``TrainStep.eager``) from a fresh state. -> (metrics, launches of the nine
    kernels, peak GB allocated in the step, (K5, K6) from the tables), and with
    ``grads`` a float32 copy of the gradient of every leaf the norm reads."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer

    g = torch.Generator(device=DEVICE).manual_seed(0)
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1000),
                               use_ema=cfg.use_ema)
    step = make_train_step(model, cfg, seed=0, device=DEVICE, clip_model=teacher)
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    m = step.eager(state, batch, text_embed, draws=draws)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = [c.launches for c in counters]
    opt = state.optimizer
    tables = adamw_launches(opt)
    m = {k: v.clone() for k, v in m.items()}
    out = (m, launches, peak, tables)
    if grads:
        out += ({n: t.grad.float().clone() for n, t in opt.trainable + opt.frozen},)
    del model, state, step, opt
    torch.cuda.empty_cache()
    return out


def grad_gap(g, base):
    """-> (leaves not equal bit for bit, the largest leaf gap relative to the
    leaf's largest magnitude, that leaf's name, the relative gap of the global
    norm summed in float64) between two gradient sets."""
    import torch

    differ, worst, name = 0, 0.0, None
    for n, b in base.items():
        if torch.equal(g[n], b):
            continue
        differ += 1
        gap = float((g[n] - b).abs().max() / b.abs().max().clamp_min(1e-30))
        if gap > worst:
            worst, name = gap, n
    norm = lambda gs: math.sqrt(sum(float(t.double().square().sum()) for t in gs.values()))
    nb = norm(base)
    return differ, worst, name, abs(norm(g) - nb) / nb


def phase_alt_backbones():
    """Phase 19: the flagship with ConvNeXt-XL and with FocalNet-L at full
    width, bf16, bs2 on 896 x 1344, eager (to bound the run's time): one eval
    batch (finite outputs, K1 12 and K2 6, peak GB) and one train step (finite
    loss and grad_norm, the launches, peak GB)."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.train.engine import eval_forward

    free_memory()
    print(f"  at the start: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    for name in ALT_BACKBONES:
        t0 = time.perf_counter()
        cfg = flagship_cfg(backbone=name)
        g = torch.Generator(device=DEVICE).manual_seed(0)
        model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
        n_bb = sum(p.numel() for n, p in model.named_parameters() if n.startswith("backbone."))
        text_embed = torch.randn((cfg.num_classes, 1024), generator=g, device=DEVICE)
        batch = eval_batch(g, CANVAS)
        with torch.inference_mode():
            eval_forward(model, cfg, batch, text_embed)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.ms_deform_attn.launches = k2.encoder_tail.launches = 0
        t = time.perf_counter()
        with torch.inference_mode():
            r = eval_forward(model, cfg, batch, text_embed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        check_eval_out(r, cfg)
        n = (k1.ms_deform_attn.launches, k2.encoder_tail.launches)
        print(f"  {name}: backbone {n_bb / 1e6:.1f} M parameters; one eager eval batch "
              f"{ms:.1f} ms, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
              f"K1 {n[0]}, K2 {n[1]}", flush=True)
        if n != (cfg.enc_layers + cfg.dec_layers, cfg.enc_layers):
            fail(f"the {name} eval forward did not launch K1 12 and K2 6 times")
        del model, r
        torch.cuda.empty_cache()
        teacher, text_embed, tg = teacher_and_text(cfg)
        t = time.perf_counter()
        m, launches, peak, (k5, k6) = eager_step(cfg, teacher, text_embed, train_batch(tg))
        want = [12, 12, 6, 6, 0, 0, 7, k5, k6]
        print(f"  {name}: one eager train step (build included) {time.perf_counter() - t:.1f} s, "
              f"loss {float(m['loss']):.4f}, grad_norm {float(m['grad_norm']):.4f}, peak "
              f"{peak:.2f} GB; launches " + ", ".join(f"{k} {v}" for k, v in zip(COUNTED, launches))
              + f" (expect {want})", flush=True)
        if not (bool(m["finite"]) and math.isfinite(float(m["grad_norm"]))):
            fail(f"the {name} train step's loss or grad_norm is not finite")
        if launches != want:
            fail(f"the {name} train step launched {launches}, not {want}")
        del teacher
        torch.cuda.empty_cache()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print("phase 19: ConvNeXt-XL and FocalNet-L eval and train steps ok", flush=True)


def fused_tail_route_check():
    """F-P14 on the card: one encoder layer at the production width (d 256, F
    2048, bf16) on bs2's 24,990 tokens an image, its sampler's output fixed.
    With ``enc_fused_tail=False`` K2 does not launch and the layer's output is
    the modules' composition (``ffn(norm1(src + attn))``) bit for bit; with
    the knob on K2 launches once and agrees with it within phase 4's bf16
    bound; K2 with an f32 compute dtype on CUDA tensors refuses before any
    launch, and its message names ``enc_fused_tail=False``."""
    import torch

    from richsem_tpu_torch.models.dino import DeformableEncoderLayer, DINOConfig
    from richsem_tpu_torch.ops import fused_ffn as k2

    g = torch.Generator(device=DEVICE).manual_seed(14)
    layers = {}
    for fused in (False, True):
        c = DINOConfig(compute_dtype=torch.bfloat16, enc_fused_tail=fused)
        layers[fused] = DeformableEncoderLayer(c, device=DEVICE)
    layers[False].init_weights(g)
    layers[True].load_state_dict(layers[False].state_dict())
    n = sum(h * w for h, w in SHAPES)
    src = torch.randn((BATCH, n, 256), generator=g, device=DEVICE)
    attn = torch.randn((BATCH, n, 256), generator=g, device=DEVICE)
    for layer in layers.values():
        layer.self_attn.forward = lambda *a, **kw: attn
    out, launches = {}, {}
    with torch.inference_mode():
        for fused, layer in layers.items():
            k2.encoder_tail.launches = 0
            out[fused] = layer(src, src, None, None, None)
            launches[fused] = k2.encoder_tail.launches
        comp = layers[False].ffn(layers[False].norm1(src + attn))
    torch.cuda.synchronize()
    same = torch.equal(out[False], comp)
    err = compare("F-P14: the fused route (K2) against enc_fused_tail=False", out[True],
                  out[False], 3e-2, 0.0)
    print(f"  F-P14: enc_fused_tail=False launches K2 {launches[False]} times and gives the "
          f"composition bit for bit: {same}; the knob on launches K2 {launches[True]} times, "
          f"max abs err {err:.3e} from it", flush=True)
    if launches != {False: 0, True: 1} or not same:
        fail("F-P14: enc_fused_tail does not choose the encoder tail's route")
    p = {k: v.detach() for k, v in layers[True].named_parameters()}
    flat = (src.reshape(-1, 256)[:1024], attn.reshape(-1, 256)[:1024])
    k2.encoder_tail.launches = 0
    try:
        k2.encoder_tail(*flat, p["ffn.linear1.weight"], p["ffn.linear1.bias"],
                        p["ffn.linear2.weight"], p["ffn.linear2.bias"], p["norm1.weight"],
                        p["norm1.bias"], p["ffn.norm.weight"], p["ffn.norm.bias"], 1e-5,
                        torch.float32)
    except NotImplementedError as e:
        print(f"  F-P14: K2 in f32 refuses: {e}", flush=True)
        if "enc_fused_tail=False" not in str(e) or k2.encoder_tail.launches:
            fail("F-P14: K2's f32 refusal does not name enc_fused_tail=False, or launched")
    else:
        fail("F-P14: K2 took an f32 compute dtype")
    del layers, out, comp, src, attn


def phase_knobs():
    """Phase 20: the memory knobs on the R50 flagship at bs2 (phase 10's step,
    eager, one state, batch and draws; 562 gradient leaves). With the
    kernels: the step without a knob twice, then one step with each knob
    alone: every metric (``grad_norm`` too) and every gradient equal to the
    first knob-free step's bit for bit (ROADMAP F-P6, repaired), its peak
    memory below that step's, K1's and K2's forward launches as
    ``KNOB_LAUNCHES`` says. The same five steps with the plain versions and
    PyTorch's deterministic algorithms (``deterministic``), each again equal
    to its first step bit for bit (each step's gradients against the first's,
    leaf by leaf, printed in both settings). Then the
    train bench (``richsem_tpu_torch/bench.py``) at ``BENCH_BATCH`` 4 and 8,
    where the root bench's knobs turn ``backbone_remat`` and
    ``enc_selective_remat`` on."""
    import torch

    from richsem_tpu_torch import bench
    from richsem_tpu_torch.train.engine import step_draws

    free_memory()
    print(f"  at the start: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated", flush=True)
    t0 = time.perf_counter()
    fused_tail_route_check()
    cfg0 = flagship_cfg()
    teacher, text_embed, g = teacher_and_text(cfg0)
    batch = train_batch(g)

    def run(knob):
        cfg = flagship_cfg(**({knob: True} if knob else {}))
        draws = step_draws(cfg, BATCH, torch.Generator(device=DEVICE).manual_seed(7),
                           device=DEVICE)
        return eager_step(cfg, teacher, text_embed, batch, draws, grads=True)

    errors = []
    for plain in (False, True):
        what = "the plain versions" if plain else "the kernels"
        print(f"  with {what}", flush=True)
        base = None
        # the plain versions' autograd gathers add with atomics: PyTorch's
        # deterministic algorithms with them
        with plain_versions() if plain else contextlib.nullcontext(), \
                deterministic() if plain else contextlib.nullcontext():
            for knob in (None, None) + tuple(k for k in KNOB_LAUNCHES if k):
                t = time.perf_counter()
                m, launches, peak, (k5, k6), grads = run(knob)
                line = (f"  {knob or 'no knob'}: peak {peak:.2f} GB allocated, loss "
                        f"{float(m['loss']):.6f}, grad_norm {float(m['grad_norm']):.6f}")
                if not plain:
                    w1, w2 = KNOB_LAUNCHES[knob]
                    want = [w1, 12, w2, 6, 0, 0, 7, k5, k6]
                    line += ("; launches " + ", ".join(f"{k} {v}" for k, v in
                                                       zip(COUNTED, launches))
                             + f" (expect {want})")
                    if launches != want:
                        fail(f"the step with {knob} launched {launches}, not {want}")
                if base is None:
                    base = (m, peak, grads)
                    print(line + f"; {time.perf_counter() - t:.1f} s", flush=True)
                    continue
                differ, worst, name, norm = grad_gap(grads, base[2])
                same = [k for k in base[0] if torch.equal(m[k], base[0][k])]
                print(line + f"; metrics equal the first step's bit for bit {len(same)}/"
                      f"{len(base[0])}; gradients: {differ}/{len(base[2])} leaves differ from "
                      f"the first step's, largest {worst:.3e} of its leaf's magnitude ({name}), "
                      f"global norm {norm:.3e}; peak {peak - base[1]:+.2f} GB; "
                      f"{time.perf_counter() - t:.1f} s", flush=True)
                if differ or len(same) != len(base[0]):
                    errors.append(f"{knob or 'a second step'} changes a metric or a gradient "
                                  f"with {what}")
                if knob and not plain and not peak < base[1]:
                    fail(f"{knob} does not lower the step's peak memory")
                del grads
        del base
    if errors:
        fail("; ".join(errors))
    del teacher
    torch.cuda.empty_cache()
    want = dict(BENCH_LAUNCHES["train"], K2=12)  # enc_selective_remat runs the tail again
    for bs in BENCH_BATCHES:
        t = time.perf_counter()
        line = bench.bench_line(env={"BENCH_BATCH": str(bs)})
        print(json.dumps(line), flush=True)
        print(f"  train bench bs{bs}: {line['value']:.3f} img/s, busy {line['device_busy_ms']:.1f}"
              f" ms, peak {line['peak_memory_gb']:.2f} GB; {time.perf_counter() - t:.1f} s",
              flush=True)
        if not (line["value"] > 0 and line["graph"] and f"bs{bs}" in line["metric"]):
            fail(f"the bs{bs} train bench line holds a value out of range")
        if line["launches_per_step"] != want:
            fail(f"the bs{bs} train bench launched {line['launches_per_step']}, not {want}")
        torch.cuda.empty_cache()
    print(f"phase 20: memory knobs and the bs4 and bs8 train lines ok "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


# The settings under which ``phase_sources`` repeats a step: (name, the plain
# versions of the model's kernels, PyTorch's deterministic algorithms, cuDNN's
# deterministic mode)
SOURCE_SETTINGS = (("the kernels", False, False, False),
                   ("the plain versions", True, False, False),
                   ("the kernels + deterministic algorithms", False, True, False),
                   ("the kernels + cuDNN deterministic", False, False, True),
                   ("the kernels + both", False, True, True),
                   ("the plain versions + deterministic algorithms", True, True, False),
                   ("the plain versions + cuDNN deterministic", True, False, True),
                   ("the plain versions + both", True, True, True))


@contextlib.contextmanager
def torch_settings(algos: bool, cudnn_det: bool):
    """PyTorch's deterministic algorithms (a warning names any operation that
    has none; uninitialized memory not filled) and cuDNN's deterministic
    convolutions, each on or as it was, put back after."""
    import torch
    import torch.utils.deterministic as det

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            det.fill_uninitialized_memory)
    if algos:
        torch.use_deterministic_algorithms(True, warn_only=True)
        det.fill_uninitialized_memory = False
    if cudnn_det:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[2:4]
        det.fill_uninitialized_memory = prev[4]


def deterministic():
    """Both of ``torch_settings``: under them the plain versions' steps repeat
    bit for bit (their autograd gathers add with atomics otherwise)."""
    return torch_settings(True, True)


@contextlib.contextmanager
def body_settings_off():
    """The train step's body without its own cuDNN setting
    (``train/engine.py:deterministic_convolutions``), so that the settings
    around it hold, put back after: for ``phase_sources``."""
    from richsem_tpu_torch.train import engine

    saved = engine.deterministic_convolutions
    engine.deterministic_convolutions = contextlib.nullcontext
    try:
        yield
    finally:
        engine.deterministic_convolutions = saved


def leaf_gaps(g, base):
    """-> {leaf: max |g - base| / max |base|} over the leaves that differ."""
    import torch

    return {n: float((g[n] - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for n, b in base.items() if not torch.equal(g[n], b)}


def phase_sources():
    """The sources of the train step's run-to-run differences (ROADMAP F-P6):
    two eager steps of the R50 flagship at bs2 from one state, batch and
    draws, in both decoder routes, under each of ``SOURCE_SETTINGS``: the
    metrics equal or not, ``grad_norm``'s relative gap, and every leaf's gap
    (its largest difference over its largest magnitude; all of them written
    to ``build/sources.log``, the largest printed), with the warnings
    PyTorch's deterministic algorithms give for operations without a
    deterministic version (the body's own cuDNN setting,
    ``deterministic_convolutions``, taken out for these). Then two eager
    steps of each other trained path (DINO, variants A and B, the ViT recipe,
    Swin-L, ConvNeXt-XL, FocalNet-L, DETRsegm at bs1, CondInst) as shipped,
    their metrics and every leaf's gap; and the flagship's train graph under
    each setting of the kernels, 10 replays timed (ms/step, the host's clock
    to a synchronise): the cost of each setting."""
    import collections
    import warnings

    import torch

    from richsem_tpu_torch.train.engine import step_draws

    t0 = time.perf_counter()
    print(f"  CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r}; "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark}, cudnn.deterministic "
          f"{torch.backends.cudnn.deterministic}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    log = open(os.path.join(ROOT, "build", "sources.log"), "w")

    def caught(ws):
        return sorted({str(w.message).splitlines()[0][:200] for w in ws})

    for route in (None, "sep_pallas"):
        cfg = flagship_cfg(**({"dec_msda_impl": route} if route else {}))
        teacher, text_embed, g = teacher_and_text(cfg)
        batch = train_batch(g)
        draws = step_draws(cfg, BATCH, torch.Generator(device=DEVICE).manual_seed(7),
                           device=DEVICE)
        for name, plain, algos, cudnn_det in SOURCE_SETTINGS:
            runs, ms = [], []
            with warnings.catch_warnings(record=True) as ws:
                warnings.simplefilter("always")
                with (plain_model_kernels() if plain else contextlib.nullcontext()), \
                        body_settings_off(), torch_settings(algos, cudnn_det):
                    for _ in range(2):
                        t = time.perf_counter()
                        m, _, _, _, grads = eager_step(cfg, teacher, text_embed, batch, draws,
                                                       grads=True)
                        ms.append((time.perf_counter() - t) * 1e3)
                        runs.append((m, grads))
            (m1, g1), (m2, g2) = runs
            same = [k for k in m1 if torch.equal(m1[k], m2[k])]
            gaps = leaf_gaps(g2, g1)
            rel = abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) / float(m1["grad_norm"])
            by_mod = collections.Counter(n.split(".")[0] for n in gaps)
            tag = f"{route or 'default decoder'}, {name}"
            print(f"  {tag}: metrics equal {len(same)}/{len(m1)}, grad_norm "
                  f"{float(m1['grad_norm']):.9g} vs {float(m2['grad_norm']):.9g} ({rel:.3e}); "
                  f"{len(gaps)}/{len(g1)} leaves differ"
                  + (f", by module {dict(by_mod.most_common(12))}" if gaps else "")
                  + f"; eager steps (with the build) {ms[0]:.0f}, {ms[1]:.0f} ms", flush=True)
            for n in sorted(gaps, key=gaps.get, reverse=True)[:6]:
                print(f"    {n}: {gaps[n]:.3e}", flush=True)
            for w in caught(ws):
                print(f"    warning: {w}", flush=True)
            log.write(f"# {tag}\n" + "".join(f"{n} {gaps.get(n, 0.0):.6e}\n" for n in g1))
            del runs, g1, g2, grads
        del teacher, text_embed
        free_memory()

    def one_step(what, cfg, teacher=None, text_embed=None, batch=None):
        t = time.perf_counter()
        runs = [eager_step(cfg, teacher, text_embed, batch, grads=True) for _ in range(2)]
        (m1, *_, g1), (m2, *_, g2) = runs
        same = [k for k in m1 if torch.equal(m1[k], m2[k])]
        gaps = leaf_gaps(g2, g1)
        by_mod = collections.Counter(n.split(".")[0] for n in gaps)
        print(f"  {what}, two eager steps as shipped: loss {float(m1['loss']):.4f}, "
              f"metrics equal {len(same)}/{len(m1)}, {len(gaps)}/{len(g1)} leaves differ"
              + (f" {dict(by_mod.most_common(8))}, largest {max(gaps, key=gaps.get)} "
                 f"{max(gaps.values()):.3e}" if gaps else "")
              + f"; {time.perf_counter() - t:.1f} s", flush=True)
        log.write(f"# {what}\n" + "".join(f"{n} {gaps.get(n, 0.0):.6e}\n" for n in g1))
        del runs, g1, g2
        free_memory()

    from richsem_tpu_torch.config import Config

    g = torch.Generator(device=DEVICE).manual_seed(0)
    cfg = Config.fromfile(TRAIN_CONFIG)
    cfg.compute_dtype = "bfloat16"
    one_step("DINO", cfg, batch=train_batch(g))
    for v in ("A", "B"):
        cfg = flagship_cfg(**variant(v))
        teacher, text_embed, tg = teacher_and_text(cfg)
        batch = train_batch(tg)
        if v == "B":
            for k in ("labels", "boxes", "valid"):
                batch[k] = batch[k][:, :VARIANT_B_GT].contiguous()
        one_step(f"variant {v}", cfg, teacher, text_embed, batch)
        del teacher, text_embed
    cfg = flagship_cfg(clip_model=VIT, use_visual_distill=False)
    teacher, text_embed = vit_teacher_and_text(cfg)
    one_step("ViT-B/32 recipe", cfg, teacher, text_embed, train_batch(g))
    del teacher, text_embed
    cfg = flagship_cfg(backbone=SWIN)
    teacher, text_embed, tg = teacher_and_text(cfg)
    one_step("Swin-L", cfg, teacher, text_embed, train_batch(tg))
    del teacher, text_embed
    for name in ALT_BACKBONES:
        cfg = flagship_cfg(backbone=name)
        teacher, text_embed, tg = teacher_and_text(cfg)
        one_step(name, cfg, teacher, text_embed, train_batch(tg))
        del teacher, text_embed
    for head in MASK_HEADS:
        one_step(head, masks_cfg(head), batch=mask_train_batch(g, 1))
    log.close()

    # the cost of each setting in the flagship's train graph
    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer

    cfg = flagship_cfg()
    teacher, text_embed, tg = teacher_and_text(cfg)
    batch = train_batch(tg)
    for name, plain, algos, cudnn_det in SOURCE_SETTINGS:
        if plain:
            continue
        with body_settings_off(), torch_settings(algos, cudnn_det):
            gm = torch.Generator(device=DEVICE).manual_seed(0)
            model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=gm)
            state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1000),
                                       use_ema=cfg.use_ema)
            step = make_train_step(model, cfg, seed=0, device=DEVICE, clip_model=teacher)
            step(state, batch, text_embed)  # warm-up and capture
            step(state, batch, text_embed)
            torch.cuda.synchronize()
            times = []
            for _ in range(10):
                t = time.perf_counter()
                step(state, batch, text_embed)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
        print(f"  flagship train graph with {name}: ms/step median "
              f"{statistics.median(times):.2f} (min {min(times):.2f}, max {max(times):.2f})",
              flush=True)
        step.reset()
        del model, state, step
        free_memory()
    print(f"phase sources: the train step's sources of run-to-run differences "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


MXU_KERNELS = ("mxu_kernel", "mxu_reduce_kernel")
CELL_KERNELS = ("cell_kernel", "cell_reduce_kernel")
REPEAT_KERNELS = {"float32": "repeat_f32_kernel", "bfloat16": "repeat_bf16_kernel"}


# the device operations of an earlier tree's backward wrapper around its
# kernel (``ab``): the zeroed f32 d_value scratch and its cast to the value's
# dtype
SCRATCH_OPS = {"zero": "FillFunctor", "cast": "copy_kernel"}


def profile_once(fn, top: int = 12, also: dict = None, counts: dict = None) -> dict:
    """Device time by kernel over one call of ``fn``, read by
    ``utils/profiling.py:profile_call``: prints the busiest ``top`` kernels, then
    every hand-written one. -> device ms of each hand-written kernel that ran,
    and of the operations whose names hold each substring in ``also`` under its
    key ({} when nothing was recorded); ``counts``, if given, gets how many
    operations each of those sums."""
    from richsem_tpu_torch.utils.profiling import profile_call

    prof = profile_call(fn)
    if prof is None:
        print("  profile: no device time recorded (not measured)")
        return {}
    print("\n".join(prof.summary(top)))
    out, n = {}, {}
    for k, (c, ms) in prof.kernels().items():
        out[k], n[k] = ms, c
    for k, sub in (also or {}).items():
        hit = prof.matching(sub)
        if hit:
            n[k], out[k] = hit
    if counts is not None:
        counts.update(n)
    if also:
        print("    " + "; ".join(f"{k} ({sub}) " + (f"{out[k]:.4f} ms" if k in out else "not seen")
                                for k, sub in also.items()))
    return out


def device_ms(fn, kernels, iters: int = 5, also: dict = None, per_call: dict = None,
              counts: dict = None) -> dict:
    """Device ms of ``fn`` over ``iters`` profiled calls. For each hand-written
    kernel in ``kernels``: the mean a launch over the launches the profile
    recorded (a profile can miss some calls' kernels, PERF.md §7), times the
    launches a call makes (``per_call``, by kernel, 1 by default). For each key
    of ``also`` (see ``profile_once``): the mean a call. None for one that the
    profile did not record (not measured). A profile that missed a kernel, or
    whose count of an ``also`` key's operations is not a multiple of ``iters``
    (a call's lost), is taken again, three tries in all. ``counts`` receives
    the last profile's counts of operations."""
    also, per_call = also or {}, per_call or {}
    for attempt in range(3):  # a profile now and then misses operations
        n = {}
        dev = profile_once(lambda: [fn() for _ in range(iters)],
                           top=len(kernels) + len(also), also=also, counts=n)
        if (dev and all(n.get(k) for k in kernels)
                and all(n[k] % iters == 0 for k in also if k in n)):
            break
        print(f"  profile: operations of some call not recorded (attempt {attempt + 1} of 3)")
    if counts is not None:
        counts.update(n)
    out = {k: dev[k] / n[k] * per_call.get(k, 1) if n.get(k) else None for k in kernels}
    out.update({k: dev[k] / iters if k in dev else None for k in also})
    return out


def total_ms(dev: dict):
    """The sum of ``device_ms``'s times, None unless all were measured."""
    return None if None in dev.values() else sum(dev.values())


def measured_sum(dev: dict):
    """The sum of ``device_ms``'s times that were measured, None if none was
    (a tree whose kernel has fewer ``__global__`` functions adds what it has)."""
    got = [v for v in dev.values() if v is not None]
    return sum(got) if got else None


ALL_OPS = {"all": ""}  # device_ms's ``also``: every device operation of the call
# the parts of the d_value pass of K1-bwd and K3-bwd, in this tree (count,
# shift, scatter, convert) or in an earlier one (scans, place, gather), and
# the memset of the counts
PASS_OPS = {"count": "dvalue_count", "shift": "dvalue_shift", "scatter": "dvalue_scatter",
            "convert": "dvalue_convert", "scan": "dvalue_scan", "place": "dvalue_place",
            "gather": "_gather_kernel", "memset": "Memset"}


def phase_ab(root: str, msda_only: bool = False) -> None:
    """The ``ab`` subcommand: the model's kernels of the port in ``root`` (only
    K1, K3, K3-bwd and K1-bwd where ``msda_only``)."""
    import hashlib

    import torch

    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.ops import ms_deform_attn_sep as k3
    from richsem_tpu_torch.tools import bench_cal, bench_cell
    from richsem_tpu_torch.tools import bench_vpu_model as vm

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(k1.__file__))))
    if pkg_root != root:
        fail(f"ab: richsem_tpu_torch came from {pkg_root}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    rec = {"root": root, "card": smi}

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy())
        return h.hexdigest()[:16]

    value, cases = k1_cases()
    v = value.to(torch.bfloat16)
    for case, (loc, aw) in cases.items():
        fn = lambda: k1.ms_deform_attn(v, SHAPES, loc, aw)  # noqa: E731
        rec[f"k1_{case}_ms"] = cuda_ms(fn)
        rec[f"k1_{case}_device_ms"] = total_ms(device_ms(fn, ["msda_fwd_kernel"]))
        rec[f"k1_{case}_sha"] = digest([fn()])
    # K3 and K3-bwd on phases 8 and 9's inputs (the decoder's, bf16)
    loc, aw = cases["decoder"]
    grad = torch.randn((v.shape[0], loc.shape[1], 256),
                       generator=torch.Generator(device=DEVICE).manual_seed(4),
                       device=DEVICE).to(torch.bfloat16)
    fn = lambda: k3.ms_deform_attn_sep(v, SHAPES, loc, aw)  # noqa: E731
    rec["k3_ms"] = cuda_ms(fn)
    rec["k3_device_ms"] = total_ms(device_ms(fn, ["msda_sep_fwd_kernel"]))
    rec["k3_sha"] = digest([fn()])
    # K1-bwd and K3-bwd: the tap kernel alone, the wrapper's zeroed f32 d_value
    # and its cast where a tree has them, every device operation of a call
    # ("all"), and each part of the d_value pass a tree has (PASS_OPS)
    bwd_ops = dict(ALL_OPS, **SCRATCH_OPS, **PASS_OPS)
    fn = lambda: k3.ms_deform_attn_sep_backward(v, SHAPES, loc, aw, grad)  # noqa: E731
    rec["k3_bwd_ms"] = cuda_ms(fn, iters=10)
    dev = device_ms(fn, ["msda_sep_bwd_kernel"], also=bwd_ops)
    for key, op in (("device", "msda_sep_bwd_kernel"), ("zero_device", "zero"),
                    ("cast_device", "cast"), ("all_device", "all"),
                    *((f"{p}_device", p) for p in PASS_OPS)):
        rec[f"k3_bwd_{key}_ms"] = dev[op]
    rec["k3_bwd_sha"] = digest(fn())
    for name, t in zip(("d_value", "d_loc", "d_aw"), fn()):
        rec[f"k3_bwd_{name}_sha"] = digest([t])
    for case, seed in (("encoder", 3), ("decoder", 3)):
        loc, aw = cases[case]
        grad = torch.randn((v.shape[0], loc.shape[1], 256),
                           generator=torch.Generator(device=DEVICE).manual_seed(seed),
                           device=DEVICE).to(torch.bfloat16)
        fn = lambda: k1.ms_deform_attn_backward(v, SHAPES, loc, aw, grad)  # noqa: E731
        rec[f"k1_bwd_{case}_ms"] = cuda_ms(fn, iters=10)
        dev = device_ms(fn, ["msda_bwd_kernel"], also=bwd_ops)
        rec[f"k1_bwd_{case}_device_ms"] = dev["msda_bwd_kernel"]
        rec[f"k1_bwd_{case}_all_device_ms"] = dev["all"]
        for p in PASS_OPS:
            rec[f"k1_bwd_{case}_{p}_device_ms"] = dev[p]
        rec[f"k1_bwd_{case}_sha"] = digest(fn())
        for name, t in zip(("d_value", "d_loc", "d_aw"), fn()):
            rec[f"k1_bwd_{case}_{name}_sha"] = digest([t])
    if msda_only:
        print(json.dumps(rec), flush=True)
        return
    del value, cases, v, loc, aw, grad
    args, dy = k2_args()
    fn = lambda: k2.encoder_tail(*args)  # noqa: E731
    rec["k2_ms"] = cuda_ms(fn)
    rec["k2_device_ms"] = total_ms(device_ms(fn, ["encoder_tail_fwd_kernel"]))
    rec["k2_sha"] = digest([fn()])
    fn = lambda: k2.encoder_tail_backward(*args, dy)  # noqa: E731
    rec["k2_bwd_ms"] = cuda_ms(fn, iters=10)
    rec["k2_bwd_device_ms"] = total_ms(device_ms(fn, ["row_pass_kernel", "dw_gemm_kernel",
                                                      "colsum_kernel"],
                                                 per_call={"colsum_kernel": 4}))
    rec["k2_bwd_sha"] = digest(fn())
    del args, dy
    # the probe kernels redesigned in PR 8 at their main() shapes: mxu, fma, tile
    g = torch.Generator(device=DEVICE).manual_seed(12)
    s = bench_cal.S
    for k, d in MXU_SHAPES:
        a = torch.randn((k, s), generator=g, device=DEVICE).to(torch.bfloat16)
        b = torch.randn((s, d), generator=g, device=DEVICE).to(torch.bfloat16)
        fn = lambda: bench_cal.mxu(a, b, 512)  # noqa: E731
        key = f"mxu_{k}_{d}"
        rec[f"{key}_ms"] = cuda_ms(fn)
        rec[f"{key}_device_ms"] = measured_sum(device_ms(fn, MXU_KERNELS))
        rec[f"{key}_bound_ms"] = bound3(**mxu_cost(a, b, 512))[0]
        rec[f"{key}_sha"] = digest([fn()])
    del a, b
    big = (vm.T, vm.M, vm.WY, vm.WXP, vm.K)
    hy = torch.randn(big[:3] + (4 * vm.K,), generator=g, device=DEVICE)
    hx = torch.randn(big[:2] + (vm.WXP, 4 * vm.K), generator=g, device=DEVICE)
    for label, p, two in FMA_CASES:
        fn = ((lambda: vm.fma_chunk(hy, hx, 4)) if label == "fma-4-chunk"
              else (lambda: vm.fma(hy, hx, p, two)))
        rec[f"{label}_ms"] = cuda_ms(fn, iters=10)
        rec[f"{label}_device_ms"] = measured_sum(device_ms(fn, ["fma_kernel"]))
        rec[f"{label}_bound_ms"] = bound3(**fma_cost(hy, hx, p))[0]
        rec[f"{label}_sha"] = digest([fn()])
    del hy, hx
    x = torch.arange(8, dtype=torch.float32, device=DEVICE)[None].repeat(8, 1)
    fn = lambda: bench_cell.tile(x, 2)  # noqa: E731
    rec["tile_ms"] = cuda_ms(fn)
    rec["tile_device_ms"] = measured_sum(device_ms(fn, ["tile_kernel"]))
    rec["tile_library_device_ms"] = device_ms(lambda: x.repeat(1, 2), [], also=ALL_OPS)["all"]
    rec["tile_sha"] = digest([fn()])
    # cell at phase 12's inputs, vpu bf16 at its shapes (inputs from a seed of their own)
    (yr, xr, aw), wins = bench_cell.cell_inputs(DEVICE)
    fn = lambda: bench_cell.cell(yr, xr, aw, wins, 64)  # noqa: E731
    rec["cell_ms"] = cuda_ms(fn, iters=10)
    dev = device_ms(fn, CELL_KERNELS)
    rec["cell_device_ms"] = measured_sum(dev)
    rec.update({f"cell_{k}_device_ms": v for k, v in dev.items()})
    rec["cell_bound_ms"] = bound3(**cell_cost(yr, xr, aw, wins, 64))[0]
    out, again = fn(), fn()
    rec["cell_sha"] = digest([out])
    rec["cell_two_calls_equal"] = bool(torch.equal(out, again))
    del yr, xr, aw, wins, out, again
    x, y = vpu_inputs(uniform_draws(13), torch.bfloat16)
    fn = lambda: bench_cal.vpu(x, y, 512)  # noqa: E731
    rec["vpu_bf16_ms"] = cuda_ms(fn)
    rec["vpu_bf16_device_ms"] = measured_sum(device_ms(fn, ["vpu_bf16_kernel"]))
    rec["vpu_bf16_bound_ms"] = bound3(**vpu_cost(x, 512))[0]
    rec["vpu_bf16_sha"] = digest([fn()])
    del x, y
    # run_repeat at phase 12's shapes, both dtypes (inputs from a seed of their own)
    rand = uniform_draws(14)
    for dt in (torch.float32, torch.bfloat16):
        x = rand(bench_cal.ROWS, 32, lo=-2, hi=2, dtype=dt)
        fn = lambda: bench_cal.repeat(x, 52, 256)  # noqa: E731
        key = f"repeat_{str(dt)[6:]}"
        rec[f"{key}_ms"] = cuda_ms(fn)
        rec[f"{key}_device_ms"] = measured_sum(device_ms(fn, [REPEAT_KERNELS[str(dt)[6:]]]))
        rec[f"{key}_bound_ms"] = bound3(**repeat_cost(x))[0]
        rec[f"{key}_sha"] = digest([fn()])
    # K4 on phase 15's correlated case (B 2, P 300, 16 valid, O 900; the same
    # draws)
    from richsem_tpu_torch.ops import lap

    c, v = auction_random(torch.Generator(device=DEVICE).manual_seed(11), N_VALID,
                          AUCTION_SPREAD)
    fn = lambda: lap._auction_cuda(c, v, True, 3000, 1e-4)  # noqa: E731
    obj, stats = fn()
    rounds = int(stats[:, 0].max())
    rec["k4_ms"] = cuda_ms(fn)
    rec["k4_device_ms"] = device_ms(fn, ["auction_kernel"])["auction_kernel"]
    rec["k4_rounds"] = rounds
    rec["k4_us_per_round"] = (rec["k4_device_ms"] / rounds * 1e3
                              if rec["k4_device_ms"] and rounds else None)
    rec["k4_sha"] = digest([obj, stats])
    del c, v
    try:  # K5 and K6 at phase 16's inputs (a tree before them has neither)
        from richsem_tpu_torch.ops import adamw
    except ImportError:
        adamw = None
    if adamw is not None:
        model, opt, leaves, sets = adamw_case()
        grads, saved = sets[0], opt_copy(opt)
        fn = lambda: adamw.global_norm_clip(grads, opt.clip_max_norm)  # noqa: E731
        rec["k5_ms"] = cuda_ms(fn)
        rec["k5_device_ms"] = measured_sum(device_ms(fn, ["sumsq_kernel",
                                                          "sumsq_finish_kernel"]))
        state = fn()[1]
        rec["k5_sha"] = digest([state])
        opt.prepare()
        for order in adamw.ORDERS:
            fn = k6_call(opt, grads, state, order)
            rec[f"k6_{order}_ms"] = cuda_ms(fn)
            rec[f"k6_{order}_device_ms"] = device_ms(fn, ["adamw_kernel"])["adamw_kernel"]
            opt_put(opt, saved)
            fn()
            rec[f"k6_{order}_sha"] = digest([p for _, p in opt.trainable] + opt.mu + opt.nu)
            opt_put(opt, saved)
        del model, opt, leaves, sets, saved
    # K7 on phase 21's random bs2 x 300 case (the eval's N and threshold) and
    # on N 1,024 (the same draws)
    from richsem_tpu_torch.ops import nms

    cases = {c[0]: c[1:] for c in k7_cases(torch.Generator(device=DEVICE).manual_seed(21))}
    for key, case in (("k7_300", "random bs2 N 300"), ("k7_1024", "N 1024")):
        boxes, scores, thr = cases[case]
        fn = lambda: nms._nms_cuda(boxes, scores, thr)  # noqa: E731
        rec[f"{key}_ms"] = cuda_ms(fn)
        rec[f"{key}_device_ms"] = device_ms(fn, ["nms_kernel"])["nms_kernel"]
        rec[f"{key}_sha"] = digest([fn()])
    print(json.dumps(rec), flush=True)


def nccl_ops(prof):
    """(count, device ms) of NCCL's kernels in a profile: a collective's
    (``ncclDevKernel_*``), or the one-rank reduce (``onerank.cu``) that a
    one-rank group launches for AVG."""
    n, ms = 0, 0.0
    for key, count, t in prof.ops:
        if "nccl" in key.lower() or "onerank" in key.lower():
            n, ms = n + count, ms + t
    return n, ms


@contextlib.contextmanager
def recorded_evals():
    """Record what each ``LvisEvaluator`` is given while the context is open: a
    list with a dict (image id -> scores, labels, boxes on the host) an
    evaluator, appended at its first update."""
    from richsem_tpu_torch.data.evaluation import LvisEvaluator

    evals, real = [], LvisEvaluator.update

    def update(self, predictions):
        if not hasattr(self, "_recorded"):
            self._recorded = {}
            evals.append(self._recorded)
        self._recorded.update({int(k): tuple(p[f].copy() for f in ("scores", "labels", "boxes"))
                               for k, p in predictions.items()})
        return real(self, predictions)

    LvisEvaluator.update = update
    try:
        yield evals
    finally:
        LvisEvaluator.update = real


def replay_profile(run, cfg):
    """A guarded profile of one replay of ``train_loop``'s step (``run``) on the
    first batch of its loader, with the statistics the trainer hands a step
    -> (profile, retakes, gradient collectives issued a profiled call)."""
    from richsem_tpu_torch.bench import guarded_profile
    from richsem_tpu_torch.parallel import dist as pdist
    from richsem_tpu_torch.train import main as trainer
    from richsem_tpu_torch.train.engine import train_graph_key

    d, step, state = run["dist"], run["train_step"], run["state"]
    host = next(iter(trainer.build_loaders(cfg, d.rank, d.world)[0].epoch(0)))
    host.update(pdist.step_stats(d, host, cfg))
    batch = trainer.place_batch(host, DEVICE)
    fed = next(iter(step.graphs.values())).inputs.get("fed_weight")
    if fed is not None:
        batch["fed_weight"] = fed.clone()
    if train_graph_key(batch, None, state.ema is not None) not in step.graphs:
        fail("the first batch's train graph was not captured")
    before = pdist.average_.launches
    prof, retakes = guarded_profile(lambda: step(state, batch))
    return prof, retakes, (pdist.average_.launches - before) / (retakes + 1)


def phase_ddp(recs, smi):
    """Phase 17: ``train_loop`` as the one rank of an NCCL group (the launcher's
    environment set, world size 1), on phase 13's config and synthetic LVIS
    for one epoch, beside two runs of it without a group: the group's backend
    and device, the steps and launches of phase 13's first run and one
    gradient collective a step, the parameters within the two single-process
    runs' spread (F-P6, held as ``graph_vs_eager`` holds a replay), the
    epoch's eval (gathered) equal to a single-process ``evaluate`` of the same
    parameters, guarded profiles of replays in turns with a single-process
    run's on one batch (exactly one NCCL kernel in each; its device ms, the
    busy ms beside the single-process replay's and phase 10's, the averaged
    buffer's bytes and the operations the collective adds), and ``--eval``
    under the group writing ``eval.json``."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from richsem_tpu_torch.data.synthetic import write_lvis
    from richsem_tpu_torch.parallel import dist as pdist
    from richsem_tpu_torch.train import main as trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    env = {k: os.environ.get(k) for k in pdist.LAUNCH_ENV}
    try:
        root = write_lvis(os.path.join(tmp, "lvis"))

        def cfg_for(out, *extra):
            args = ["-c", TRAIN_CONFIG, "--output_dir", os.path.join(tmp, out), "--data_root",
                    root, "--device", DEVICE, "--options", "epochs=1", *extra]
            return trainer.load_config(trainer.get_args_parser().parse_args(args))

        def params_of(run):
            return {"params": {n: p.detach().clone()
                               for n, p in run["state"].model.named_parameters()}}

        cfg = cfg_for("a")
        _, val_loader, _, val_ds = trainer.build_loaders(cfg)
        eval_batches = val_loader.num_batches_hint(0)
        singles = []
        for out in ("a", "b"):
            t = time.perf_counter()
            run = trainer.train_loop(cfg_for(out))
            torch.cuda.synchronize()
            singles.append(params_of(run))
            steps = run["state"].step
            print(f"  single-process train_loop ({out}): {steps} steps in "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
            if out == "a":  # its graphs kept for the profiles in turns below
                single_run = run
            del run
            torch.cuda.empty_cache()

        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                          MASTER_PORT=str(pdist.free_port()))
        counters = launch_counters()
        for c in counters:
            c.launches = 0
        pdist.average_.launches = 0
        t = time.perf_counter()
        with recorded_evals() as gathered:
            run = trainer.train_loop(cfg_for("c"))
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        collectives = pdist.average_.launches
        d, step, state = run["dist"], run["train_step"], run["state"]
        where = next(state.model.parameters()).device
        print(f"  train_loop under the launcher's environment: {state.step} steps in "
              f"{time.perf_counter() - t:.1f} s; group {dist.get_backend()}, rank {d.rank} of "
              f"{d.world}, parameters on {where}", flush=True)
        if not (d.active and d.backend == "nccl" == dist.get_backend() and d.world == 1
                and str(where) == "cuda:0"):
            fail("phase 17 did not run as the one rank of an NCCL group on cuda:0")
        logs = [json.loads(line) for line in open(os.path.join(tmp, "c", "log.txt"))]
        forwards = eval_batches + logs[0]["eval_graphs"]
        want = [12 * (steps + forwards), 12 * steps, 6 * (steps + forwards), 6 * steps, 0, 0,
                7 * steps, steps, steps]
        print("  launches " + ", ".join(f"{k} {n}" for k, n in zip(COUNTED, launches))
              + f" (expect {want}, phase 13's first run: 12/12/6/6/7/1/1 a step); gradient "
              f"collectives {collectives} (expect {steps}, one a step)", flush=True)
        if state.step != steps or launches != want or collectives != steps:
            fail("the data-parallel run did not take phase 13's steps and launches, or not one "
                 "gradient collective a step")
        for rec, n in zip(recs, launches):
            rec["ddp_launches"] = n
        if [e["epoch"] for e in logs] != [0] or not os.listdir(os.path.join(tmp, "c", "ckpt")):
            fail("rank 0 did not write one epoch's log line and its checkpoint")

        # F-P6: the parameters against the single-process runs' spread
        ends = params_of(run)
        ab, ca = param_spread(*singles), param_spread(ends, singles[0])
        big = max(float(p.abs().max()) for p in singles[0]["params"].values())
        d_max = max(max(ab.values()), ulp(torch.tensor(big)))
        d_l2 = max(param_l2(*singles), d_max)
        c_l2 = param_l2(ends, singles[0])
        print(f"  parameters after the epoch (F-P6): two single-process runs differ in "
              f"{sum(v > 0 for v in ab.values())}/{len(ab)} leaves, largest {max(ab.values()):.3e}, "
              f"l2 {param_l2(*singles):.3e}; the NCCL run against the first: "
              f"{sum(v > 0 for v in ca.values())} leaves, largest {max(ca.values()):.3e} (bound "
              f"{2 * d_max:.3e}), l2 {c_l2:.3e} (bound {2 * d_l2:.3e})", flush=True)
        if max(ca.values()) > 2 * d_max or c_l2 > 2 * d_l2:
            fail("the NCCL run's parameters lie outside the single-process runs' spread")
        del ends, singles

        # the epoch's eval came through the gather path: one process on the same parameters
        with recorded_evals() as single:
            one = trainer.evaluate(cfg, state.model, val_loader, val_ds, device=DEVICE)
        keys = ("AP", "AP50", "AP75", "APr", "APc", "APf")
        a, b = gathered[-1], single[-1]
        same = a.keys() == b.keys() and all(
            all(np.array_equal(x, y) for x, y in zip(a[k], b[k])) for k in a)
        print(f"  eval, gathered to rank 0: {len(a)} images' predictions, equal to one "
              f"process's bit for bit: {same}; " + ", ".join(
                  f"{k} {logs[0][k]:.4f}/{one[k]:.4f}" for k in keys), flush=True)
        if not same or any(logs[0][k] != one[k] for k in keys):
            fail("the gathered eval differs from the single-process eval of the same parameters")

        # replays profiled in turns, the single-process run's and this one's, on one
        # batch: NCCL's kernel inside the graph, and what the collective adds
        profs = {"single": [], "nccl": []}
        for _ in range(3):
            profs["single"].append(replay_profile(single_run, cfg)[0])
            prof, _, per_call = replay_profile(run, cfg)
            profs["nccl"].append(prof)
            n_nccl, nccl_ms = nccl_ops(prof)
            if n_nccl != 1 or per_call != 1:
                fail("the replayed train graph does not hold exactly one NCCL all-reduce")
        busy = {k: statistics.median(p.busy_ms for p in v) for k, v in profs.items()}
        phase10 = REPLAY_BUSY.get("phase 10")
        print(f"  replay profiles in turns ({smi}): busy "
              f"{', '.join(f'{p.busy_ms:.2f}' for p in profs['nccl'])} ms (median "
              f"{busy['nccl']:.2f}), {prof.n_ops} operations, against the single-process "
              f"replay of the same batch {', '.join(f'{p.busy_ms:.2f}' for p in profs['single'])}"
              f" (median {busy['single']:.2f}), {profs['single'][-1].n_ops} operations; phase "
              f"10's flagship replay "
              f"{'not measured' if phase10 is None else f'{phase10:.2f} ms'}", flush=True)
        print(f"  NCCL kernels a replay: 1, {nccl_ms:.4f} ms device time over "
              f"{step.reduce_bytes} bytes ({step.reduce_bytes / 1e6:.1f} MB: every gradient "
              f"the norm reads and the metrics)", flush=True)
        ops = [{k: (n, ms) for k, n, ms in p[-1].ops} for p in (profs["single"], profs["nccl"])]
        added = sorted(((k, n - ops[0].get(k, (0, 0.0))[0], ms - ops[0].get(k, (0, 0.0))[1])
                        for k, (n, ms) in ops[1].items() if n != ops[0].get(k, (0, 0.0))[0]),
                       key=lambda r: -r[2])
        print("  operations whose count the collective changes (the last pair of profiles): "
              + "; ".join(f"{k[:70]} {n:+d}, {ms:+.4f} ms" for k, n, ms in added), flush=True)
        for rec in recs:
            rec["ddp_replay_busy_ms"] = busy["nccl"]
        del run, step, state, single_run, profs
        torch.cuda.empty_cache()

        ev_run = trainer.train_loop(cfg_for("c", "--eval"))
        ev = json.load(open(os.path.join(tmp, "c", "eval.json")))
        print(f"  --eval under the group: eval.json step {ev['step']}, AP {ev['AP']:.4f} "
              f"(epoch's {logs[0]['AP']:.4f})", flush=True)
        if ev["step"] != steps or ev["AP"] != logs[0]["AP"] or ev_run["eval"]["AP"] != ev["AP"]:
            fail("--eval under the group did not write the restored step's AP")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    print("phase 17: train_loop as one rank of an NCCL group: one all-reduce in the replayed "
          "graph", flush=True)


# ---- the recipe variants (phases 21 and 22) and K7 --------------------------
VARIANT_B_GT = 100  # phase 22's GT slots: CDN's group-count branch pads 4 * dn_number * G
# variant A's leaves whose gradients run_train compares with the plain versions'
VARIANT_A_LEAVES = GRAD_LEAVES[:5] + ("vl_proj.layer3.weight", "clip_query_proj.weight",
                                      "enc_cls_kernel", GRAD_LEAVES[6])
NMS_THR = 0.7  # variant A's nms_iou_threshold


def variant(name):
    """The overrides of variant A ("semantic": the five semantic-branch knobs,
    check_pos_dn, OptMatcher, NMS at 0.7) or B ("groups and tail": dn_number 5,
    gelu, dropout 0.1, HungarianMatcherCPU), set here, in code."""
    from richsem_tpu_torch.tools.gemm_sites import VARIANT_A

    if name == "A":
        return dict(VARIANT_A, nms_iou_threshold=NMS_THR)
    return dict(dn_number=5, transformer_activation="gelu", dropout=0.1,
                matcher_type="HungarianMatcherCPU")


def k7_chain(device):
    """K7's word-boundary chain: 70 boxes whose scores fall with the index,
    given in a shuffled order; those ranked 29-35 each overlap the next at
    IoU 2/3 and the one after at 3/7, the rest overlap nothing. At 0.5, 29
    removes 30, 30 is gone and 31 stays and removes 32 across the word
    boundary, and so on: of the chain, 29, 31, 33 and 35 stay."""
    import torch

    n = 70
    r = torch.arange(n, dtype=torch.float32)
    x = (r % 10) * 100
    y = (r // 10) * 100
    chain = (r >= 29) & (r <= 35)
    x = torch.where(chain, (r - 29) * 2, x)
    y = torch.where(chain, torch.full_like(y, 2000.0), y)
    size = torch.where(chain, torch.full_like(x, 10.0), torch.full_like(x, 20.0))
    boxes = torch.stack([x, y, x + size, y + size], -1)
    scores = 1 - r / 128
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(5))
    return boxes[perm][None].to(device), scores[perm][None].to(device)


def k7_cases(g):
    """K7's inputs, [B, N, 4] xyxy f32 boxes and [B, N] f32 scores on the card:
    bs2 at the eval's N 300 with scores rounded to 1e-2 (many ties), the
    constructed case of tied scores and IoUs exactly at the threshold (1/3 and
    1/2, kept: the rule is iou > threshold), the word-boundary chain
    (``k7_chain``), N 1,024 (the limit), 1,000, 33 and 1."""
    import torch

    def rand(b, n, thr):
        xy = torch.rand((b, n, 2), generator=g, device=DEVICE) * 800
        wh = torch.rand((b, n, 2), generator=g, device=DEVICE) * 200 + 1
        scores = (torch.rand((b, n), generator=g, device=DEVICE) * 100).round() / 100
        return torch.cat([xy, xy + wh], -1), scores, thr

    tied = torch.tensor([[[0, 0, 10, 10], [0, 0, 10, 20], [0, 0, 10, 10], [5, 0, 15, 10],
                          [0, 0, 10, 10.5], [40, 40, 50, 50], [40, 40, 50, 50]]],
                        dtype=torch.float32, device=DEVICE)
    tied_scores = torch.tensor([[0.5, 0.9, 0.5, 0.5, 0.9, 0.3, 0.3]], device=DEVICE)
    return [("random bs2 N 300", *rand(2, 300, NMS_THR)),
            ("ties and IoU at 1/2", tied, tied_scores, 0.5),
            ("ties and IoU at 1/3", tied, tied_scores, 1 / 3),
            ("chain across a word boundary", *k7_chain(DEVICE), 0.5),
            ("N 1024", *rand(2, 1024, 0.5)), ("N 1000", *rand(2, 1000, 0.5)),
            ("N 33", *rand(3, 33, 0.5)), ("N 1", *rand(2, 1, 0.5))]


def phase_k7(rec, eval_inputs=None):
    """K7 against the plain version on CUDA tensors, keep masks exactly equal,
    on ``k7_cases`` and on the eval's own boxes and scores (``eval_inputs``);
    then, on the eval's inputs (or the random case) and on N 1,024: its device
    time (five profiled calls), CUDA-event time and its passes apart (rank,
    IoU, sweep, scatter: the median of 21 stamped launches,
    ``ops/nms.py:pass_split``); on the first also the plain loop's host and
    device time, the bound (each input read once and the mask written once,
    against the IoU pairs' f32 operations at the issue rate) and the sweep's
    latency floor: ceil(N / 32) dependent block steps at the time of one block
    step alone on one warp (``ops/nms.py:block_floor``)."""
    import torch

    from richsem_tpu_torch.ops import nms

    t0 = time.perf_counter()
    g = torch.Generator(device=DEVICE).manual_seed(21)
    cases = k7_cases(g)
    if eval_inputs is not None:
        cases.insert(0, ("the eval's own (bs2, top-300)", *eval_inputs))
    for name, boxes, scores, thr in cases:
        keep = nms._nms_cuda(boxes, scores, thr)
        ref = nms.nms_mask_plain(boxes, scores, thr)
        torch.cuda.synchronize()
        same = torch.equal(keep, ref)
        print(f"  K7 {name}: keep masks equal {same}; kept {int(keep.sum())} of "
              f"{keep.numel()} at threshold {thr:.4g}", flush=True)
        if not same:
            fail(f"K7 differs from the plain NMS on {name}")
        if name.startswith("chain"):
            ranked = keep[0][torch.sort(-scores[0], stable=True).indices]
            if ranked[29:36].tolist() != [True, False] * 3 + [True]:
                fail(f"K7 on the chain kept {ranked[29:36].tolist()} of ranks 29-35")
    floor = nms.block_floor()
    timed = [cases[0], next(c for c in cases if c[0] == "N 1024")]
    for i, (name, boxes, scores, thr) in enumerate(timed):
        fn = lambda: nms._nms_cuda(boxes, scores, thr)  # noqa: E731
        kern = device_ms(fn, ["nms_kernel"])["nms_kernel"]
        ms = cuda_ms(fn)
        split = nms.pass_split(boxes, scores, thr)
        b, n = scores.shape
        latency_ms = (n + 31) // 32 * floor["ns"] / 1e6
        print(f"  K7 on {name}: device {_ms(kern)} ms a launch, CUDA events {ms:.4f} ms; "
              "passes (median of 21 stamped launches) "
              + ", ".join(f"{p} {ns / 1e3:.3f} us = {cyc:.0f} cycles"
                          for p, (ns, cyc) in split.items())
              + f"; the sweep's floor {(n + 31) // 32} block steps x {floor['ns']:.2f} ns "
              f"({floor['cycles']:.1f} cycles) = {latency_ms:.5f} ms", flush=True)
        passes = {p: v[0] for p, v in split.items()}
        if i:
            rec.update({"n1024_device_ms": kern, "n1024_ms": ms, "n1024_passes_ns": passes,
                        "n1024_latency_bound_ms": latency_ms})
            continue
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            nms.nms_mask_plain(boxes, scores, thr)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3 / 5
        plain_dev = device_ms(lambda: nms.nms_mask_plain(boxes, scores, thr), [], iters=1,
                              also=ALL_OPS)["all"]
        bms, by = bound(nbytes(boxes, scores) + b * n, b * n * (n - 1) / 2 * 12, F32_ISSUE_OPS)
        print(f"  K7 on {name}: plain loop: host {plain_ms:.3f} ms, device {_ms(plain_dev)} ms; "
              f"bound {bms:.6f} ms ({by})", flush=True)
        rec.update({"max_abs_err": 0.0, "ms": ms, "device_ms": kern, "plain_ms": plain_ms,
                    "plain_device_ms": plain_dev, "bound_ms": bms, "bound_by": by,
                    "library_ms": None, "latency_bound_ms": latency_ms,
                    "block_step_ns": floor["ns"], "case": name, "passes_ns": passes})
    print(f"  K7 phase {time.perf_counter() - t0:.1f} s", flush=True)


def phase_variant_a(k7_rec, train=True):
    """Phase 21, variant A ("semantic") at the flagship's full width, bf16,
    bs2 on 896 x 1344, random weights (seed 0) and the random bf16 RN50
    teacher: the eval graph (the teacher's spatial pass, K1 12, K2 6 and K7 1
    a batch; 3 replays, each against its eager body bit for bit; ms/batch,
    img/s, peak memory), K7 on the eval's own boxes (``phase_k7``), then the
    train graph (``run_train``: 5 replays, K4 0 a step since every matched set
    goes through simOTA, a replay under set_sync_debug_mode("error"), the
    replay against one eager step, gradients against the plain versions, the
    f32 CUDA-core GEMMs of a replay). ``train=False`` stops after the eval
    part (the ``k7`` mode)."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.models import postprocess as post
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.ops import nms
    from richsem_tpu_torch.train.engine import eval_forward, make_eval_step

    free_memory()
    t0 = time.perf_counter()
    cfg = flagship_cfg(**variant("A"))
    print(f"  variant A: {variant('A')}", flush=True)
    teacher, text_embed, _ = teacher_and_text(cfg)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    batches = [eval_batch(g, CANVAS) for _ in range(N_BATCHES + 1)]
    step = make_eval_step(model, cfg, teacher)
    step(batches[-1], text_embed)  # warm-up and capture
    torch.cuda.synchronize()
    (graph,) = step.graphs.values()
    print(f"  eval setup + warm-up + capture {time.perf_counter() - t0:.1f} s (warm-up + "
          f"capture {graph.capture_ms:.1f} ms, pool {step.pool_bytes / 1e9:.3f} GB)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    k1.ms_deform_attn.launches = k2.encoder_tail.launches = nms.nms_mask.launches = 0
    times, results = [], []
    for batch in batches[:N_BATCHES]:
        t = time.perf_counter()
        results.append(step(batch, text_embed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    got = (k1.ms_deform_attn.launches, k2.encoder_tail.launches, nms.nms_mask.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in results:
        check_eval_out(r, cfg)
    dropped = [int((r["scores"] == -1).sum()) for r in results]
    want = ((cfg.enc_layers + cfg.dec_layers) * N_BATCHES, cfg.enc_layers * N_BATCHES, N_BATCHES)
    ms_batch = statistics.median(times)
    print(f"  eval (CUDA graph replays): {', '.join(f'{t:.2f}' for t in times)} ms/batch; median "
          f"{ms_batch:.2f} ms/batch = {BATCH * 1e3 / ms_batch:.3f} img/s; peak memory "
          f"{peak_gb:.2f} GB allocated; launches K1 {got[0]}, K2 {got[1]}, K7 {got[2]} (expect "
          f"{want}); boxes NMS dropped a batch {dropped} of {BATCH * cfg.num_select}", flush=True)
    if got != want:
        fail("the variant A eval path did not launch K1 12, K2 6 and K7 1 times a batch")
    k7_rec["launches"] = got[2]
    for i, batch in enumerate(batches[:N_BATCHES]):
        graphed = step(batch, text_embed)
        with torch.inference_mode():
            eager = eval_forward(model, cfg, batch, text_embed, teacher)
        torch.cuda.synchronize()
        same = all(torch.equal(graphed[k], eager[k]) for k in ("scores", "labels", "boxes"))
        print(f"  replay {i} equals its eager body bit for bit: {same}", flush=True)
        if not same:
            fail("the variant A eval graph differs from its eager body")
    seen = []
    kept = post.nms_mask
    post.nms_mask = lambda b, s, thr: seen.append((b.clone(), s.clone(), thr)) or kept(b, s, thr)
    try:
        with torch.inference_mode():
            eval_forward(model, cfg, batches[0], text_embed, teacher)
    finally:
        post.nms_mask = kept
    del step, results, graphed, eager, graph
    free_memory()
    phase_k7(k7_rec, seen[0])
    del model, seen
    free_memory()
    t1 = time.perf_counter()
    print(f"  eval part {t1 - t0:.1f} s", flush=True)
    if not train:
        return
    run_train(cfg, (12, 12, 6, 6, 0, 0, 0, None, None), N_STEPS, VARIANT_A_LEAVES,
              clip_model=teacher, text_embed=text_embed, phase="phase 21", against_eager="one")
    print(f"  train part {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"phase 21: variant A eval and train graphs ok ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def dropout_graph_check():
    """Dropout in a CUDA graph (phase 22's last check), at a cut width that
    captures in seconds: dino_4scale_lvis.py with one encoder and one decoder
    layer, 100 queries, dropout 0.1, bs2 at 256 x 384. A replay against one
    eager step from one state, batch, draws and dropout seed (the pre-update
    metrics bit for bit: the graph draws from the generator registered with
    it), then two replays a step apart with the same draws, whose losses must
    differ (each replay draws anew)."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer

    cfg = Config.fromfile(TRAIN_CONFIG)
    cfg.update(compute_dtype="bfloat16", enc_layers=1, dec_layers=1, num_queries=100,
               dropout=0.1)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1000))
    step = make_train_step(model, cfg, seed=0, device=DEVICE)
    h, w = 256, 384
    pad = torch.zeros(BATCH, h, w, dtype=torch.bool, device=DEVICE)
    batch = {"images": torch.rand((BATCH, h, w, 3), generator=g, device=DEVICE) * 2 - 1,
             "pad_mask": pad,
             "labels": torch.randint(0, 1203, (BATCH, 20), generator=g, device=DEVICE),
             "boxes": torch.rand((BATCH, 20, 4), generator=g, device=DEVICE) * 0.5 + 0.2,
             "valid": (torch.arange(20, device=DEVICE) < 8)[None].expand(BATCH, -1)}
    step(state, batch)  # the warm-up step and the capture
    torch.cuda.synchronize()
    graph_vs_eager(step, state, batch, what="dropout 0.1 train (cut width)")
    draws = step.draws(state, BATCH)
    losses = [float(step(state, batch, draws=draws)["loss"]) for _ in range(2)]
    print(f"  two replays a step apart, same draws: loss {losses[0]:.6f} and {losses[1]:.6f}",
          flush=True)
    if losses[0] == losses[1]:
        fail("two replays with dropout drew the same masks")
    step.reset()


def phase_variant_b():
    """Phase 22, variant B ("groups and tail") at the flagship's full width,
    bf16, bs2 on 896 x 1344 with ``VARIANT_B_GT`` GT slots (16 valid): the
    step on the card refuses a graph (``HungarianMatcherCPU`` reads the cost
    on the host), so two eager steps (K1 12 and K1-bwd 12 a step, K2 and K4 0:
    the gelu tail is the modules' composition and SciPy matches), finite
    losses; SciPy's assignment of the first matching against K4's on the same
    cost, equal total cost (the auction is optimal within n_valid * eps); peak
    memory; then ``dropout_graph_check``."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model, matcher
    from richsem_tpu_torch.ops import lap
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer

    free_memory()
    t0 = time.perf_counter()
    cfg = flagship_cfg(**variant("B"))
    pad = 4 * cfg.dn_number * VARIANT_B_GT
    print(f"  variant B: {variant('B')}; {VARIANT_B_GT} GT slots, {N_VALID} valid: a DN pad of "
          f"4 x {cfg.dn_number} x {VARIANT_B_GT} = {pad} slots and {pad + cfg.num_queries} decoder "
          f"queries (the bench's 300 slots would pad {4 * cfg.dn_number * MAX_GT})", flush=True)
    teacher, text_embed, g = teacher_and_text(cfg)
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1000),
                               use_ema=cfg.use_ema)
    step = make_train_step(model, cfg, seed=0, device=DEVICE, clip_model=teacher)
    batches = []
    for _ in range(2):
        b = train_batch(g)
        for k in ("labels", "boxes", "valid"):
            b[k] = b[k][:, :VARIANT_B_GT].contiguous()
        batches.append(b)
    try:
        step(state, batches[0], text_embed)
        fail("the variant B step on the card did not refuse a graph")
    except RuntimeError as e:
        if "HungarianMatcherCPU" not in str(e):
            raise
        print(f"  the step refuses a graph: {e}", flush=True)
    seen = []
    solve = matcher.scipy_assignment

    def keep(c, v):
        col = solve(c, v)
        if not seen:
            seen.append((c.clone(), v.clone(), col.clone()))
        return col

    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    matcher.scipy_assignment = keep
    times, metrics = [], []
    try:
        for b in batches:
            t = time.perf_counter()
            metrics.append(step.eager(state, b, text_embed))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    finally:
        matcher.scipy_assignment = solve
    launches = [c.launches for c in counters]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k5, k6 = adamw_launches(state.optimizer)
    want = [12 * 2, 12 * 2, 0, 0, 0, 0, 0, k5 * 2, k6 * 2]
    for i, m in enumerate(metrics):
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        print(f"  eager step {i}: {times[i]:.1f} ms, loss {loss:.4f}, grad_norm {gnorm:.4f}, "
              f"loss_ce_dn {float(m['loss_ce_dn']):.4f}, loss_distill {float(m['loss_distill']):.4f}",
              flush=True)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"variant B step {i}: loss or grad_norm is not finite")
    print(f"  launches over 2 eager steps: "
          + ", ".join(f"{k} {n}" for k, n in zip(COUNTED, launches)) + f" (expect {want}); "
          f"peak memory {peak_gb:.2f} GB allocated", flush=True)
    if launches != want:
        fail("the variant B steps did not launch the kernels as expected")
    c, v, col = seen[0]
    k4 = lap.batched_min_cost_assignment(c, v)
    rows = v.nonzero(as_tuple=True)

    def total(cols):
        return float(c.double()[rows[0], rows[1], cols[rows]].sum())

    scale = float(c[v].abs().max().clamp(min=1e-6))
    slack = int(v.sum()) * 1e-4 * scale
    ts, tk = total(col), total(k4)
    print(f"  the first matching ({tuple(c.shape)}, {int(v.sum())} valid rows): SciPy total "
          f"cost {ts:.6f}, K4 {tk:.6f} (the auction within {slack:.3g}); same assignment "
          f"{torch.equal(col, k4)}", flush=True)
    if not abs(tk - ts) <= slack:
        fail("HungarianMatcherCPU's total cost differs from K4's on the same cost")
    del step, state, model, metrics
    free_memory()
    dropout_graph_check()
    print(f"phase 22: variant B eager steps ok ({time.perf_counter() - t0:.1f} s)", flush=True)


# ---- the ViT-B/32 teacher (phase 23) and the weak labels as a rank (phase 24) --
VIT = "ViT-B/32"
LARGE_CANVAS = (1344, 2048)  # phase 23 (b): a 42 x 64 teacher map, past 2,048 cells
ROI_GATHER_TOL = 1e-5  # phase 23 (b): gather crops vs matmul crops, of the largest magnitude
WEAK_LABELS = dict(use_imagenet_pusedo_labels=True, clip_pusedo_th=0.05, clip_pusedo_topk=4)


def deterministic_replay_check(make_step, state, batch, text_embed, what):
    """A replay against an eager step, bit for bit before and after the update,
    with the plain versions of the model's kernels and PyTorch's deterministic
    algorithms (``plain_model_kernels``, ``deterministic``), under which steps
    repeat (phase 20): a new step from ``make_step()`` captures its graph (its
    warm-up step and capture run from the saved state), then one replay and
    one eager step, each from that state with one batch and set of draws;
    every metric and the parameters, moments and EMA after the update must be
    equal. Leaves the state as it found it."""
    import torch

    saved = state_copy(state)
    t = time.perf_counter()
    with plain_model_kernels(), deterministic():
        step = make_step()
        draws = step.draws(state, *batch["labels"].shape)
        step(state, batch, text_embed, draws=draws)  # warm-up (eager) and capture
        runs = []
        for run in (step, step.eager):
            state_put(state, saved)
            m = run(state, batch, text_embed, draws=draws)
            torch.cuda.synchronize()
            runs.append(({k: v.clone() for k, v in m.items()}, state_copy(state)))
        state_put(state, saved)
        step.reset()
    (mr, sr), (me, se) = runs
    metrics = [k for k in me if not torch.equal(mr[k], me[k])]
    same = same_state(sr, se)
    print(f"  {what}: replay vs eager step, plain model kernels + deterministic algorithms "
          f"({time.perf_counter() - t:.1f} s): metrics equal {len(me) - len(metrics)}/{len(me)} "
          f"(loss {float(mr['loss']):.6f}, grad_norm {float(mr['grad_norm']):.9g}); "
          f"parameters, moments and EMA after the update equal bit for bit: {same}",
          flush=True)
    if metrics or not same:
        fail(f"the {what} replay differs from its eager step with the plain model kernels: "
             f"metrics {metrics}, state equal {same}")
    del runs, step
    free_memory()


def vit_teacher_and_text(cfg):
    """The random-weight bf16 ViT-B/32 teacher (seed 2) and its 1204 x 512
    text bank, the text tower over seeded token ids: a start token, 2-18
    random word ids, the end token (the largest id) and zeros (the BPE merges
    are not in the repository)."""
    import torch

    from richsem_tpu_torch.models.build import build_clip_teacher

    g = torch.Generator(device=DEVICE).manual_seed(2)
    teacher = build_clip_teacher(cfg, dtype=torch.bfloat16, device=DEVICE, generator=g)
    c = teacher.cfg
    n, ctx = cfg.num_classes, c.context_length
    ids = torch.randint(1, c.vocab_size - 2, (n, ctx), generator=g, device=DEVICE)
    ends = torch.randint(3, 20, (n,), generator=g, device=DEVICE)
    pos = torch.arange(ctx, device=DEVICE)
    ids = torch.where(pos[None] < ends[:, None], ids, 0)
    ids[:, 0] = c.vocab_size - 2
    ids[torch.arange(n, device=DEVICE), ends] = c.vocab_size - 1
    with torch.no_grad():
        text = torch.cat([teacher.encode_text(ids[i:i + 256]) for i in range(0, n, 256)])
    return teacher, text


def train_replays(cfg, want, teacher, text_embed, batch_of, dist=None, what="train"):
    """The train graph of ``cfg`` from seed 0: one warm-up step (eager, then the
    capture) and ``N_STEPS`` replays on batches from ``batch_of(g)``: finite
    losses, the launches of the nine kernels a step (``want``; K5 and K6 None:
    from the optimizer's tables), ms/step, img/s, peak memory. -> (model,
    state, step, the batches, launches a step)."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer

    g = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1000),
                               use_ema=cfg.use_ema)
    step = make_train_step(model, cfg, seed=0, device=DEVICE, clip_model=teacher, dist=dist)
    batches = [batch_of(g) for _ in range(N_STEPS + 1)]
    m = step(state, batches[-1], text_embed)
    torch.cuda.synchronize()
    (graph,) = step.graphs.values()
    print(f"  {what}: setup + warm-up step {time.perf_counter() - t0:.1f} s, loss "
          f"{float(m['loss']):.4f}; warm-up + capture {graph.capture_ms:.1f} ms, pool "
          f"{step.pool_bytes / 1e9:.3f} GB", flush=True)
    want = tuple(want[:7]) + tuple(
        n if n is not None else t for n, t in zip(want[7:], adamw_launches(state.optimizer)))
    counters = launch_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for batch in batches[:N_STEPS]:
        t = time.perf_counter()
        metrics.append(step(state, batch, text_embed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = [c.launches // N_STEPS for c in counters]
    for i, m in enumerate(metrics):
        terms = ", ".join(f"{k} {float(m[k]):.4f}" for k in ("loss", "grad_norm", "loss_ce",
                                                             "loss_bbox", "loss_distill")
                          if k in m)
        print(f"  step {i}: {terms}", flush=True)
        if not (bool(m["finite"]) and math.isfinite(float(m["grad_norm"]))):
            fail(f"{what} step {i}: the loss or grad_norm is not finite")
    ms = statistics.median(times)
    print(f"  {what} (CUDA graph replays): {', '.join(f'{t:.2f}' for t in times)} ms/step; "
          f"median {ms:.2f} ms/step = {BATCH * 1e3 / ms:.3f} img/s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated; launches a step "
          + ", ".join(f"{k} {n}" for k, n in zip(COUNTED, launches)) + f" (expect {list(want)})",
          flush=True)
    if tuple(launches) != want or any(c.launches % N_STEPS for c in counters):
        fail(f"the {what} replays did not launch the kernels as expected")
    n_ops = {}
    dev = profile_once(lambda: step(state, batches[1], text_embed), top=6, also=ALL_OPS,
                       counts=n_ops)
    print(f"  {what}: a replay's device time {_ms(dev.get('all'))} ms over {n_ops.get('all')} "
          f"operations", flush=True)
    return model, state, step, batches, launches


def phase_vit(recs):
    """Phase 23: the ViT-B/32 recipe (``richsem_4scale_lvis.py`` with
    ``clip_model="ViT-B/32"``) at full width, bf16, bs2, random weights (seed
    0), the random bf16 ViT-B/32 teacher and its 1204 x 512 text bank
    (``vit_teacher_and_text``).
    (a) Serving, with ``use_clip_visual_query`` (and ``use_visual_distill``,
        which the knob requires): the eval graph at 896 x 1344 runs the
        teacher's spatial pass (28 x 42 patches and the class token through 12
        layers of width 768) in the step; 3 replays, each against its eager
        body bit for bit; K1 12 and K2 6 a batch; ms/batch, img/s, peak GB.
    (b) One eager eval batch at 1344 x 2048, whose 42 x 64 map takes RoIAlign's
        gather path (``method="auto"``, sampling ratio 2): its crops against the
        matmul path's on the same map and boxes, TF32 off, within
        ``ROI_GATHER_TOL`` of the largest magnitude; K1 12 and K2 6.
    (c) Training with ``use_visual_distill=False`` (the teacher's bank feeds the
        classifier): the train graph, 5 replays, finite losses, K1 12, K1-bwd
        12, K2 6, K2-bwd 6, K4 7, K5 1, K6 1 a step; the replay against an
        eager step bit for bit before and after the update under the plain
        model kernels and deterministic algorithms.
    (d) Training under ``use_visual_distill`` raises where JAX's step does, at
        ``attnpool``, which the ViT lacks."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model, dino
    from richsem_tpu_torch.models.clip_align import clip_spatial_features
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.ops import roi_align as ra
    from richsem_tpu_torch.train.engine import eval_forward, make_eval_step, make_train_step

    free_memory()
    t0 = time.perf_counter()
    cfg = flagship_cfg(clip_model=VIT, use_clip_visual_query=True)
    teacher, text_embed = vit_teacher_and_text(cfg)
    print(f"  ViT-B/32 teacher: {sum(p.numel() for p in teacher.parameters()) / 1e6:.1f} M "
          f"parameters, bf16 tower; text bank {tuple(text_embed.shape)} ("
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    g = torch.Generator(device=DEVICE).manual_seed(0)
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    if model.clip_query_proj.weight.shape[1] != 512:
        fail("the visual queries' projection does not take the ViT's 512-wide map")
    batches = [eval_batch(g, CANVAS) for _ in range(N_BATCHES + 1)]
    step = make_eval_step(model, cfg, teacher)
    step(batches[-1], text_embed)  # warm-up and capture
    torch.cuda.synchronize()
    (graph,) = step.graphs.values()
    print(f"  (a) eval warm-up + capture {graph.capture_ms:.1f} ms, pool "
          f"{step.pool_bytes / 1e9:.3f} GB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    k1.ms_deform_attn.launches = k2.encoder_tail.launches = 0
    times, results = [], []
    for batch in batches[:N_BATCHES]:
        t = time.perf_counter()
        results.append(step(batch, text_embed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    got = (k1.ms_deform_attn.launches, k2.encoder_tail.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in results:
        check_eval_out(r, cfg)
    want = ((cfg.enc_layers + cfg.dec_layers) * N_BATCHES, cfg.enc_layers * N_BATCHES)
    ms_batch = statistics.median(times)
    print(f"  (a) eval (CUDA graph replays, the ViT's spatial pass in the step): "
          f"{', '.join(f'{t:.2f}' for t in times)} ms/batch; median {ms_batch:.2f} ms/batch = "
          f"{BATCH * 1e3 / ms_batch:.3f} img/s; peak {peak_gb:.2f} GB allocated; launches K1 "
          f"{got[0]}, K2 {got[1]} (expect {want})", flush=True)
    if got != want:
        fail("the ViT-B/32 eval path did not launch K1 12 and K2 6 times a batch")
    for i, batch in enumerate(batches[:N_BATCHES]):
        graphed = step(batch, text_embed)
        with torch.inference_mode():
            eager = eval_forward(model, cfg, batch, text_embed, teacher)
        torch.cuda.synchronize()
        same = all(torch.equal(graphed[k], eager[k]) for k in ("scores", "labels", "boxes"))
        print(f"  (a) replay {i} equals its eager body bit for bit: {same}", flush=True)
        if not same:
            fail("the ViT-B/32 eval graph differs from its eager body")
    recs[0]["vit_eval_launches"], recs[2]["vit_eval_launches"] = (n // N_BATCHES for n in got)
    n_ops = {}
    dev = profile_once(lambda: step(batches[0], text_embed), top=8, also=ALL_OPS, counts=n_ops)
    with torch.inference_mode():
        alone = profile_once(lambda: clip_spatial_features(teacher, batches[0]["images"]),
                             top=3, also=ALL_OPS)
    print(f"  (a) a replay's device time {_ms(dev.get('all'))} ms over {n_ops.get('all')} "
          f"operations; the ViT's spatial pass alone (eager, bs2 896x1344) "
          f"{_ms(alone.get('all'))} ms", flush=True)
    del step, results, graphed, eager, graph
    free_memory()

    # (b) one eager batch at 1344 x 2048: the gather path, against the matmul path
    t = time.perf_counter()
    seen, kept = [], dino.roi_align

    def record(features, boxes, **kw):
        out = kept(features, boxes, **kw)
        seen.append((features.clone(), boxes.clone(), dict(kw), out.clone()))
        return out

    dino.roi_align = record
    k1.ms_deform_attn.launches = k2.encoder_tail.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.inference_mode():
            big = eval_forward(model, cfg, eval_batch(g, LARGE_CANVAS), text_embed, teacher)
        torch.cuda.synchronize()
    finally:
        dino.roi_align = kept
    check_eval_out(big, cfg)
    (feats, boxes, kw, crops), = seen
    h, w = feats.shape[1:3]
    if h * w <= ra.MATMUL_MAX_GRID or kw.get("method") != "auto":
        fail(f"the large canvas's {h}x{w} map did not take the gather path through 'auto'")
    with torch.inference_mode():
        gathered = ra.roi_align(feats, boxes, **dict(kw, method="gather"))
        matmul = ra.roi_align(feats, boxes, **dict(kw, method="matmul"))
    torch.cuda.synchronize()
    scale = float(matmul.abs().max())
    err = float((gathered - matmul).abs().max())
    print(f"  (b) eager eval at {LARGE_CANVAS[0]}x{LARGE_CANVAS[1]}: {time.perf_counter() - t:.1f}"
          f" s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, K1 "
          f"{k1.ms_deform_attn.launches}, K2 {k2.encoder_tail.launches}; the teacher's map "
          f"{h}x{w} ({h * w} cells > {ra.MATMUL_MAX_GRID}): {tuple(crops.shape)} crops of "
          f"{tuple(boxes.shape)} boxes by the gather path (the step's own equal to a direct "
          f"call: {torch.equal(crops, gathered)}); against the matmul path (TF32 off) max abs "
          f"{err:.3e} of largest {scale:.3e} (bound {ROI_GATHER_TOL:g} of it)", flush=True)
    if not torch.equal(crops, gathered) or err > ROI_GATHER_TOL * scale:
        fail("the gather path's crops differ from the matmul path's")
    if (k1.ms_deform_attn.launches, k2.encoder_tail.launches) != (12, 6):
        fail("the large-canvas eval batch did not launch K1 12 and K2 6 times")
    del seen, feats, boxes, crops, gathered, matmul, big, model
    free_memory()

    # (c) training without the distillation: the bank feeds the classifier
    tcfg = flagship_cfg(clip_model=VIT, use_visual_distill=False)
    model, state, step, batches, _ = train_replays(
        tcfg, (12, 12, 6, 6, 0, 0, 7, None, None), teacher, text_embed, train_batch,
        what="(c) ViT-B/32 recipe train")
    step.reset()
    free_memory()
    deterministic_replay_check(
        lambda: make_train_step(model, tcfg, seed=0, device=DEVICE, clip_model=teacher),
        state, batches[0], text_embed, "(c) ViT-B/32 recipe train")
    del model, state, step
    free_memory()

    # (d) the distillation needs attnpool, which the ViT lacks: JAX raises there
    dcfg = flagship_cfg(clip_model=VIT)
    try:
        eager_step(dcfg, teacher, text_embed, batches[0])
    except NotImplementedError as e:
        print(f"  (d) a train step under use_visual_distill raises as JAX's: {e}", flush=True)
        if "attnpool is the RN path" not in str(e):
            fail(f"the ViT distillation step raised another error: {e}")
    else:
        fail("a train step with the ViT teacher under use_visual_distill did not raise")
    del batches
    free_memory()
    print(f"phase 23: the ViT-B/32 recipe served, trained and refused as JAX "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_weak_labels(recs):
    """Phase 24: the CLIP flagship with the RN50 teacher and its weak labels
    (``use_imagenet_pusedo_labels``, ``clip_pusedo_th`` 0.05,
    ``clip_pusedo_topk`` 4) as the one rank of an NCCL group (world size 1, as
    phase 17), bf16, bs2 at 896 x 1344 with bench.py's batch (300 GT slots, 16
    valid) whose first image is an extra one: the train graph, 5 replays, each
    with the gradient all-reduce and the statistics gather of the rewritten
    batch (``parallel/dist.py:reduce_stats_``), counted by their wrappers and
    in a replay's profile; the reduced statistics against the group-free
    ``tensor_stats`` of the same rewritten batch, exactly; finite losses; the
    replay against an eager step as phase 23 (c)."""
    import torch
    import torch.distributed as dist

    from richsem_tpu_torch.bench import guarded_profile
    from richsem_tpu_torch.parallel import dist as pdist
    from richsem_tpu_torch.train import engine
    from richsem_tpu_torch.train.engine import make_loss_fn, make_train_step

    free_memory()
    t0 = time.perf_counter()
    env = {k: os.environ.get(k) for k in pdist.LAUNCH_ENV}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(pdist.free_port()))
    try:
        d = pdist.init_distributed(DEVICE)
        if not (d.active and d.backend == "nccl" and d.world == 1):
            fail("phase 24 did not start a one-rank NCCL group")
        cfg = flagship_cfg(**WEAK_LABELS)
        teacher, text_embed, _ = teacher_and_text(cfg)

        def batch_of(g):
            b = train_batch(g)
            b["is_extra"] = torch.arange(BATCH, device=DEVICE) == 0
            return b

        model, state, step, batches, _ = train_replays(
            cfg, (12, 12, 6, 6, 0, 0, 7, None, None), teacher, text_embed, batch_of, dist=d,
            what="weak labels, one NCCL rank")
        (graph,) = step.graphs.values()  # the collectives its capture recorded, a replay's
        per_step = [graph.launches["grad_average"], graph.launches["stats_gather"]]
        prof, retakes = guarded_profile(lambda: step(state, batches[0], text_embed))
        n_nccl, nccl_ms = nccl_ops(prof) if prof is not None else (0, float("nan"))
        print(f"  collectives a replay (its capture's record): gradient all-reduce "
              f"{per_step[0]}, statistics gather {per_step[1]}; a replay's profile: "
              f"{n_nccl} NCCL kernels, {nccl_ms:.4f} ms ({retakes} retakes), busy "
              f"{getattr(prof, 'busy_ms', float('nan')):.2f} ms", flush=True)
        if per_step != [1, 1] or n_nccl < 1:
            fail("the weak-label step did not hold one gradient all-reduce and one statistics "
                 "gather, or its replay's profile shows no NCCL kernel")

        # the reduced statistics against the group-free ones of the same rewritten batch
        seen, reduce = [], type(pdist.reduce_stats_).__call__

        def record(self, stats, dd, c):
            out = reduce(self, stats, dd, c)
            seen.append({k: v.clone() for k, v in out.items()})
            return out

        free, tensor_stats = [], engine.tensor_stats

        def record_free(b, c):
            out = tensor_stats(b, c)
            free.append({k: v.clone() for k, v in out.items()})
            return out

        draws = step.draws(state, *batches[0]["labels"].shape)
        saved = state_copy(state)
        type(pdist.reduce_stats_).__call__ = record
        try:
            step.eager(state, batches[0], text_embed, draws=draws)
        finally:
            type(pdist.reduce_stats_).__call__ = reduce
        state_put(state, saved)
        engine.tensor_stats = record_free
        try:
            with torch.no_grad():
                make_loss_fn(model, cfg, teacher)(batches[0], draws, text_embed)
        finally:
            engine.tensor_stats = tensor_stats
        torch.cuda.synchronize()
        (a,), (b,) = seen, free
        same = [k for k in b if torch.equal(a[k].to(b[k].dtype), b[k])]
        valid0 = int(batches[0]["valid"].sum())
        print(f"  reduced statistics vs the group-free tensor_stats of the rewritten batch: "
              f"{len(same)}/{len(b)} equal; gt_total {int(a['gt_total'])} (the host batch's "
              f"{valid0}), gt_max {int(a['gt_max'])}, classes {int(a['gt_classes'].sum())}, "
              f"extra_any {bool(a['extra_any'])}", flush=True)
        if len(same) != len(b):
            fail(f"the reduced statistics differ from the group-free ones: "
                 f"{sorted(set(b) - set(same))}")
        step.reset()
        free_memory()
        deterministic_replay_check(
            lambda: make_train_step(model, cfg, seed=0, device=DEVICE, clip_model=teacher,
                                    dist=d),
            state, batches[0], text_embed, "weak labels, one NCCL rank")
        del model, state, step, batches, prof, graph
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        free_memory()
    print(f"phase 24: the teacher's weak labels as one NCCL rank ({time.perf_counter() - t0:.1f}"
          f" s)", flush=True)


MASK_HEADS = ("detr", "cond_inst")
N_MASK_STEPS = 3  # replays a head's train phase times
# a head's leaves whose gradients the kernel and plain runs compare
MASK_LEAVES = {
    "detr": ("mask_attention.q_proj.weight", "mask_attention.k_proj.weight",
             "mask_head.lay1_conv.weight", "mask_head.lay2_conv.weight",
             "mask_head.adapter3.weight", "mask_head.lay5_conv.weight",
             "mask_head.out_conv.weight"),
    "cond_inst": ("cond_inst.controller.layer0.weight", "cond_inst.controller.layer2.weight",
                  "cond_inst.mask_branch.refine0_conv.weight",
                  "cond_inst.mask_branch.refine2_conv.weight",
                  "cond_inst.mask_branch.tower3_conv.weight",
                  "cond_inst.mask_branch.tower_out.weight"),
}


def masks_cfg(head, masks=True):
    """``dino_4scale_lvis.py`` in bf16 with the masks path (``head``) on or off."""
    from richsem_tpu_torch.config import Config

    cfg = Config.fromfile(TRAIN_CONFIG)
    cfg.compute_dtype = "bfloat16"
    cfg.update(masks=masks, mask_head_type=head)
    return cfg


def mask_train_batch(g, bs):
    """bench.py's batch (``train_batch``) cut to ``bs`` images, with ``masks
    [bs, MAX_GT, H/8, W/8]``: each valid GT box's extent at stride 8 in its
    image (the top-left ``size`` of the canvas), as the collate lays them."""
    import torch

    batch = {k: v[:bs] for k, v in train_batch(g).items()}
    h8, w8 = CANVAS[0] // 8, CANVAS[1] // 8
    size = batch["size"].float()[:, None, :] / 8  # [bs, 1, (h, w)] at stride 8
    cx, cy, bw, bh = batch["boxes"].float().unbind(-1)
    x0, x1 = (cx - bw / 2) * size[..., 1], (cx + bw / 2) * size[..., 1]
    y0, y1 = (cy - bh / 2) * size[..., 0], (cy + bh / 2) * size[..., 0]
    ys = torch.arange(h8, device=DEVICE).float()[:, None] + 0.5
    xs = torch.arange(w8, device=DEVICE).float()[None, :] + 0.5
    inside = ((ys >= y0[..., None, None]) & (ys < y1[..., None, None])
              & (xs >= x0[..., None, None]) & (xs < x1[..., None, None]))
    batch["masks"] = inside & batch["valid"][..., None, None]
    return batch


def head_inputs(model, head, fn):
    """The mask head's inputs in a forward ``fn()``, caught by pre-hooks: for
    DETRsegm (the queries, C5 and its pad mask) and (C5, C4, C3); for CondInst
    the three levels and the queries."""
    mods = ((model.mask_attention, model.mask_head) if head == "detr"
            else (model.cond_inst.mask_branch, model.cond_inst.controller))
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append(args)) for m in mods]
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return seen


def shared_queries(a, b):
    """The (image, position in a, position in b) of the tokens two top-900
    selections (``topk_idx`` [B, nq]) share."""
    import torch

    eq = a[:, :, None] == b[:, None, :]
    return torch.nonzero(eq, as_tuple=True)


def masks_eval(head, recs_out):
    """The eval graphs of one head and of the same detector without masks, and
    the forward's heads: see ``phase_masks``."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.models.segmentation import postprocess_segm
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.train.engine import eval_forward, make_eval_step

    t0 = time.perf_counter()
    cfg, bare_cfg = masks_cfg(head), masks_cfg(head, masks=False)
    model, _, _ = build_model("richsem", cfg, device=DEVICE,
                              generator=torch.Generator(device=DEVICE).manual_seed(0))
    bare, _, _ = build_model("richsem", bare_cfg, device=DEVICE,
                             generator=torch.Generator(device=DEVICE).manual_seed(0))
    g = torch.Generator(device=DEVICE).manual_seed(1)
    batches = [eval_batch(g, CANVAS) for _ in range(N_BATCHES + 1)]
    steps = {"masks": make_eval_step(model, cfg), "no masks": make_eval_step(bare, bare_cfg)}
    for st in steps.values():
        st(batches[-1])  # warm-up and capture
    torch.cuda.synchronize()
    times = {k: [] for k in steps}
    launches = []
    for batch in batches[:N_BATCHES] * 2:  # in turns, each twice
        for k, st in steps.items():
            k1.ms_deform_attn.launches = k2.encoder_tail.launches = 0
            t = time.perf_counter()
            r = st(batch)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t) * 1e3)
            check_eval_out(r, cfg)
            if k == "masks":
                launches.append((k1.ms_deform_attn.launches, k2.encoder_tail.launches))
    ms = {k: statistics.median(v) for k, v in times.items()}
    graphed = steps["masks"](batches[0])
    with torch.inference_mode():
        eager = eval_forward(model, cfg, batches[0])
    torch.cuda.synchronize()
    same = all(torch.equal(graphed[k], eager[k]) for k in ("scores", "labels", "boxes"))
    print(f"  {head} eval (CUDA graph replays, in turns with the same detector without "
          f"masks): {ms['masks']:.2f} ms/batch ({', '.join(f'{t:.2f}' for t in times['masks'])})"
          f" against {ms['no masks']:.2f} ({', '.join(f'{t:.2f}' for t in times['no masks'])}); "
          f"K1, K2 a batch {sorted(set(launches))} (expect [(12, 6)]); the replay equals its "
          f"eager body bit for bit: {same}; setup + warm-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    if set(launches) != {(12, 6)} or not same:
        fail(f"the {head} eval graph: launches {sorted(set(launches))}, replay = eager {same}")
    recs_out.update(eval_ms=ms["masks"], eval_ms_no_masks=ms["no masks"])
    del steps, graphed, eager, bare
    free_memory()

    # the forward's heads, eager, at the production shapes
    batch = batches[0]
    with torch.inference_mode():
        out = model(batch["images"], batch["pad_mask"])
        args = head_inputs(model, head, lambda: model(batch["images"], batch["pad_mask"]))
    keys = ("pred_masks",) if head == "detr" else ("mask_feats", "mask_params")
    shapes = {k: tuple(out[k].shape) for k in keys}
    finite = all(bool(torch.isfinite(out[k]).all()) for k in keys)
    if head == "detr":
        attn_args, conv_args = args

        def run_head():
            return model.mask_head(model.mask_attention(*attn_args), *conv_args[1:])
    else:
        (srcs,), (hs,) = args

        def run_head():
            return model.cond_inst.mask_features(srcs), model.cond_inst.controller_params(hs)
    with torch.inference_mode():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run_head()
        torch.cuda.synchronize()
        head_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        head_ms = cuda_ms(run_head, iters=3, warmup=1)
    # postprocess_segm on the top-300 queries of the flat top-300 (PostProcess's)
    c = out["pred_logits"].shape[-1]
    with torch.inference_mode():
        prob = torch.sigmoid(out["pred_logits"].float()).flatten(1)
        q = torch.topk(prob, cfg.num_select, dim=1).indices // c  # [B, 300]
        if head == "detr":
            pm = out["pred_masks"]
            sel = torch.gather(pm, 1, q[..., None, None].expand(-1, -1, *pm.shape[2:]))
        else:
            params = torch.gather(out["mask_params"], 1,
                                  q[..., None].expand(-1, -1, out["mask_params"].shape[-1]))
            boxes = torch.gather(out["pred_boxes"], 1, q[..., None].expand(-1, -1, 4))
            sel = model.cond_inst.instance_masks(out["mask_feats"], params, boxes)
        segm = postprocess_segm(sel, batch["orig_size"], CANVAS)
    torch.cuda.synchronize()
    print(f"  {head} forward: {shapes}, finite {finite}; postprocess_segm of the top-"
          f"{cfg.num_select}: {tuple(segm.shape)}, {float(segm.float().mean()):.4f} of the "
          f"pixels set; the head alone {head_ms:.2f} ms (CUDA events), {head_gb:.2f} GB above "
          f"its inputs at its peak", flush=True)
    want = ({"pred_masks": (BATCH, cfg.num_queries, CANVAS[0] // 8, CANVAS[1] // 8)}
            if head == "detr" else
            {"mask_feats": (BATCH, CANVAS[0] // 8, CANVAS[1] // 8, 8),
             "mask_params": (BATCH, cfg.num_queries, 169)})
    if shapes != want or not finite or tuple(segm.shape) != (BATCH, cfg.num_select) + CANVAS:
        fail(f"the {head} forward's mask outputs: {shapes} (want {want}), finite {finite}")
    recs_out.update(head_ms=head_ms, head_gb=head_gb)
    del sel, segm, args, run_head

    # one batch with the plain versions in place of the kernels
    with torch.inference_mode(), plain_model_kernels():
        ref = model(batch["images"], batch["pad_mask"])
    torch.cuda.synchronize()
    bi, ia, ib = shared_queries(out["topk_idx"], ref["topk_idx"])
    share = len(bi) / out["topk_idx"].numel()
    cos = {}
    if head == "detr":
        a, b = out["pred_masks"][bi, ia], ref["pred_masks"][bi, ib]
        cos["pred_masks"] = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), 0))
    else:
        feats_err = float((out["mask_feats"] - ref["mask_feats"]).abs().max())
        a, b = out["mask_params"][bi, ia], ref["mask_params"][bi, ib]
        cos["mask_params"] = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), 0))
        print(f"  {head}: mask_feats (from the input projections, before any kernel) with "
              f"the plain versions: max abs err {feats_err:.3e}", flush=True)
        if feats_err > 1e-5 * float(ref["mask_feats"].abs().max()):
            fail("CondInst's mask features depend on the model's kernels")
    print(f"  {head} vs the plain versions, one batch: two-stage selections share {share:.4f}; "
          f"on the shared queries cosine {cos}", flush=True)
    if share < 0.9 or min(cos.values()) < COS_MIN:
        fail(f"the {head} head with the kernels departs from the plain versions")
    del out, ref, model
    free_memory()


def is_oom(e: BaseException) -> bool:
    """Whether ``e`` is the card running out of memory, or a CUDA graph's
    capture that failed for it."""
    import torch

    return isinstance(e, torch.cuda.OutOfMemoryError) or isinstance(
        e.__cause__, torch.cuda.OutOfMemoryError)


def masks_train(head, recs_out):
    """One head's train graph: see ``phase_masks``."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train.engine import (create_train_state, make_loss_fn,
                                                make_train_step, step_draws)
    from richsem_tpu_torch.train.optim import build_optimizer

    cfg = masks_cfg(head)
    tried = []
    free_memory()  # the eval graphs' pools (masks_eval) back to the card first
    for bs in (BATCH, 1):
        t0 = time.perf_counter()
        g = torch.Generator(device=DEVICE).manual_seed(0)
        model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
        state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1000))
        step = make_train_step(model, cfg, seed=0, device=DEVICE)
        batches = [mask_train_batch(g, bs) for _ in range(N_MASK_STEPS + 1)]
        torch.cuda.reset_peak_memory_stats()
        try:
            m = step(state, batches[-1])  # the eager step, then the graph's capture
            break
        except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
            if not is_oom(e) or bs == 1:
                raise
            tried.append((bs, torch.cuda.max_memory_allocated() / 1e9))
            print(f"  {head} train bs{bs}: out of memory at {tried[-1][1]:.2f} GB allocated "
                  f"({str(e).splitlines()[0][:120]})", flush=True)
        del model, state, step, batches
        free_memory()
    torch.cuda.synchronize()
    (capture_ms,) = (gr.capture_ms for gr in step.graphs.values())
    print(f"  {head} train bs{bs}: setup + warm-up {time.perf_counter() - t0:.1f} s, loss "
          f"{float(m['loss']):.4f}; warm-up + capture {capture_ms:.1f} ms, pool "
          f"{step.pool_bytes / 1e9:.3f} GB", flush=True)
    counters = launch_counters()
    want = [n * N_MASK_STEPS for n in (12, 12, 6, 6, 0, 0, 7) + adamw_launches(state.optimizer)]
    for ctr in counters:
        ctr.launches = 0
    times, metrics = [], []
    for batch in batches[:N_MASK_STEPS]:
        t = time.perf_counter()
        metrics.append(step(state, batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = [ctr.launches for ctr in counters]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, m in enumerate(metrics):
        terms = {k: float(m[k]) for k in ("loss", "loss_mask", "loss_dice", "loss_ce",
                                          "grad_norm")}
        print(f"  {head} step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in terms.items()),
              flush=True)
        if not (bool(m["finite"]) and all(math.isfinite(v) for v in terms.values())
                and terms["loss_mask"] > 0 and terms["loss_dice"] > 0):
            fail(f"the {head} train step {i}: a loss is not finite, or a mask term is zero")
    ms_step = statistics.median(times)
    print(f"  {head} train (CUDA graph replays, bs{bs}): {', '.join(f'{t:.2f}' for t in times)}"
          f" ms/step, median {ms_step:.2f} ms/step = {bs * 1e3 / ms_step:.3f} img/s; peak "
          f"{peak_gb:.2f} GB allocated (the eager warm-up's and the graph's pool); launches "
          + ", ".join(f"{k} {n}" for k, n in zip(COUNTED, launches)) + f" (expect {want})",
          flush=True)
    if launches != want:
        fail(f"the {head} train step launched {launches}, not {want}")
    dev = profile_once(lambda: step(state, batches[1]), top=6, also=ALL_OPS)
    busy = dev.get("all")
    print(f"  {head} train: a replay's busy time {busy if busy is None else f'{busy:.2f}'} ms",
          flush=True)
    del metrics, m
    saved = state_copy(state)
    eager_bs = bs
    free = torch.cuda.mem_get_info()[0]
    if bs > 1 and step.pool_bytes > free:  # an eager step needs about the graph's pool
        print(f"  {head}: an eager step does not fit beside the bs{bs} graph's pool "
              f"({step.pool_bytes / 1e9:.2f} GB, {free / 1e9:.2f} GB free); graph_vs_eager "
              f"at bs1", flush=True)
        eager_bs = 1
    else:
        graph_vs_eager(step, state, batches[0], what=f"{head} train")
    step.reset()
    del step
    free_memory()
    if eager_bs != bs:  # the check on a bs1 graph, from the state the bs2 steps left
        state_put(state, saved)
        one = {k: v[:1] for k, v in batches[0].items()}
        step = make_train_step(model, cfg, seed=0, device=DEVICE)
        step(state, one)  # the bs1 graph's warm-up and capture
        graph_vs_eager(step, state, one, what=f"{head} train bs1")
        step.reset()
        del step
        free_memory()
    del saved

    # the eager steps' batch size: the plain versions' step needs more memory still
    loss_fn = make_loss_fn(model, cfg)
    draws = step_draws(cfg, eager_bs, torch.Generator(device=DEVICE).manual_seed(7),
                       device=DEVICE)
    params = dict(model.named_parameters())
    batch = {k: v[:eager_bs] for k, v in batches[0].items()}

    def grads():
        model.zero_grad(set_to_none=True)
        total, _ = loss_fn(batch, draws)
        total.backward()
        out = {n: params[n].grad.float().clone() for n in MASK_LEAVES[head]}
        model.zero_grad(set_to_none=True)
        return out

    g_k = grads()
    with plain_versions():
        g_p = grads()
    cos = {n: float(torch.nn.functional.cosine_similarity(g_k[n].flatten(), g_p[n].flatten(), 0))
           for n in MASK_LEAVES[head]}
    print(f"  {head} head's gradients at bs{eager_bs}, kernels vs plain versions: "
          + ", ".join(f"{n} {c:.5f}" for n, c in cos.items()), flush=True)
    if min(cos.values()) < COS_MIN:
        fail(f"a {head} head gradient with the kernels departs from the plain one")
    recs_out.update(train_bs=bs, train_ms=ms_step, train_busy_ms=busy, train_peak_gb=peak_gb,
                    graph_vs_eager_bs=eager_bs, oom=tried)
    del model, state, g_k, g_p, params, batch, batches
    free_memory()


def conv_yardstick(recs_out):
    """CondInst's first refine convolution (3x3, 256 -> 128 channels, f32, TF32
    off) on bs2's stride-8 map, forward and backward: cuDNN's ``F.conv2d``
    against the branch's im2col product (``models/cond_inst.py:conv_gemm``),
    CUDA-event ms (why the branch takes the product)."""
    import torch
    import torch.nn.functional as F

    from richsem_tpu_torch.models.cond_inst import conv_gemm
    from richsem_tpu_torch.models.layers import Conv

    g = torch.Generator(device=DEVICE).manual_seed(3)
    h, w = CANVAS[0] // 8, CANVAS[1] // 8
    conv = Conv(256, 128, 3, padding=1, device=DEVICE)
    conv.init_weights(g)
    x = torch.randn((BATCH, h, w, 256), generator=g, device=DEVICE).requires_grad_()

    def cudnn():
        F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, padding=1).sum().backward()

    def gemm():
        conv_gemm(conv, x).sum().backward()

    with torch.no_grad():
        a = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, padding=1).permute(0, 2, 3, 1)
        err = float((conv_gemm(conv, x) - a).abs().max() / a.abs().max())
    ms = {"cudnn": cuda_ms(cudnn, iters=3, warmup=1), "im2col": cuda_ms(gemm, iters=3, warmup=1)}
    print(f"  CondInst refine0 [{BATCH}, 256, {h}, {w}] -> 128, 3x3 f32, forward and backward: "
          f"cuDNN F.conv2d {ms['cudnn']:.2f} ms, the im2col product {ms['im2col']:.2f} ms; "
          f"outputs within {err:.2e} of the largest", flush=True)
    if err > 1e-5:
        fail("the im2col convolution departs from cuDNN's")
    recs_out["refine0_ms"] = ms


def phase_masks():
    """Phase 25, the masks path: ``dino_4scale_lvis.py`` with ``masks=True``, bf16,
    896 x 1344, 900 queries, ``dn_number`` 100, random weights (seed 0), for
    ``mask_head_type`` "detr" (DETRsegm) and then "cond_inst". Each head:

    * eval: the eval graph (which does not run the head) on 3 batches, twice,
      in turns with the same detector without masks: ms/batch of both, K1 12
      and K2 6 a batch, the replay against its eager body bit for bit;
    * the forward's heads, eager: ``pred_masks`` (or ``mask_feats`` and
      ``mask_params``) at their production shapes, finite;
      ``postprocess_segm`` of the top-300 queries; the head alone (its
      inputs caught from a forward): CUDA-event ms and the GB its peak needs;
      one batch against the plain versions (on the queries the two top-900
      selections share, cosine >= 0.9; CondInst's mask features, which no
      kernel precedes, within 1e-5);
    * train at bs2 with bench.py's batch and ``masks``, each valid GT box's
      extent at stride 8 (at bs1 if bs2 runs out of memory, both peaks
      printed): warm-up and capture, 3 replays with ``loss_mask`` and
      ``loss_dice`` finite and nonzero, the flagship's launches (K1 12, K1-bwd
      12, K2 6, K2-bwd 6, K4 7, K5 and K6 from the optimizer's tables),
      ms/step and peak GB, a profiled replay's busy ms, ``graph_vs_eager``
      (at bs1 where the eager steps do not fit beside the bs2 graph's
      pool), and the head's gradients against the same step with the plain
      versions (cosine >= 0.9; at ``graph_vs_eager``'s batch size);

    then ``conv_yardstick``: CondInst's first refine convolution by cuDNN
    and by the branch's im2col product."""

    t0 = time.perf_counter()
    out = {}
    for head in MASK_HEADS:
        out[head] = {}
        masks_eval(head, out[head])
        masks_train(head, out[head])
    conv_yardstick(out["cond_inst"])
    print("  masks path: " + json.dumps(out), flush=True)
    print(f"phase 25: the masks path (DETRsegm and CondInst) ok "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def masks_in_child() -> None:
    """Phase 25 in a process of its own (``python3 chip_smoke.py masks``), on a
    card this process has given back what it cached: DETRsegm's bs1 check
    needs a 37 GB graph pool beside its eager step, and when the child exits
    all its memory is the card's again for the phases after it."""
    free_memory()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "masks"], cwd=ROOT).returncode
    if rc:
        fail(f"phase 25 (the masks path, in its own process) exited with {rc}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "richsem_tpu_torch")) or not os.path.isfile(CONFIG):
        fail("run from the root of a checkout (richsem_tpu_torch/ and configs/ not found)")
    if sys.argv[1:2] == ["ab"]:
        root = os.path.abspath(sys.argv[2] if len(sys.argv) > 2 else ROOT)
        sys.path.insert(0, root)
        phase_ab(root, msda_only=sys.argv[3:4] == ["msda"])
        return
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    smi = phase_build()
    if sys.argv[1:] == ["k7"]:
        phase_variant_a({}, train=False)
        print(f"total {time.perf_counter() - t0:.1f} s")
        return
    if sys.argv[1:] == ["masks"]:
        phase_masks()
        print(f"total {time.perf_counter() - t0:.1f} s")
        return
    if sys.argv[1:] == ["sources"]:
        phase_sources()
        print(f"total {time.perf_counter() - t0:.1f} s")
        return
    value, cases = k1_cases()
    if sys.argv[1:] == ["bwd"]:
        phase_k1_bwd(value, cases)
        phase_k3_bwd(value, *cases["decoder"])
        print(f"total {time.perf_counter() - t0:.1f} s")
        return
    k1_rec = phase_k1(value, cases)
    k1b_rec = phase_k1_bwd(value, cases)
    k3_rec = phase_k3(value, *cases["decoder"])
    k3b_rec = phase_k3_bwd(value, *cases["decoder"])
    del value, cases
    args, dy = k2_args()
    k2_rec = phase_k2(args)
    k2b_rec = phase_k2_bwd(args, dy)
    del args, dy
    torch.cuda.empty_cache()
    k4_rec = {"name": "K4 auction (auction_kernel)", "route": "cuda",
              "source": "richsem_tpu_torch/csrc/auction.cu",
              "replaces": "richsem_tpu/ops/lap.py:193 (the lax.while_loop of auction_assignment)",
              "launches": None}
    k5_rec = {"name": "K5 global norm (sumsq_kernel, sumsq_finish_kernel)", "route": "cuda",
              "source": "richsem_tpu_torch/csrc/adamw.cu",
              "replaces": "richsem_tpu/train/optim.py:124 (optax.global_norm in fused_adamw; "
                          "clip_by_global_norm's in the chain, :179)",
              "launches": None}
    k6_rec = {"name": "K6 AdamW update (adamw_kernel<Order>)", "route": "cuda",
              "source": "richsem_tpu_torch/csrc/adamw.cu",
              "replaces": "richsem_tpu/train/optim.py:126-146 (fused_adamw's update) and "
                          ":179-184 (the optax chain's clip, Adam, decay, group scale and lr)",
              "launches": None}
    k7_rec = {"name": "K7 NMS keep masks (nms_kernel)", "route": "cuda",
              "source": "richsem_tpu_torch/csrc/nms.cu",
              "replaces": "richsem_tpu/ops/nms.py:35 (the lax.fori_loop of nms_mask; not "
                          "Pallas)",
              "launches": None}
    recs = [k1_rec, k1b_rec, k2_rec, k2b_rec, k3_rec, k3b_rec, k4_rec, k5_rec, k6_rec, k7_rec]
    if sys.argv[1:] == ["variants"]:
        phase_variant_a(k7_rec)
        phase_variant_b()
        print(f"total {time.perf_counter() - t0:.1f} s")
        print(smi)
        print(json.dumps({"kernels": recs}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:] == ["teacher"]:
        phase_vit(recs)
        phase_weak_labels(recs)
        print(f"total {time.perf_counter() - t0:.1f} s")
        return
    if sys.argv[1:] == ["knobs"]:
        phase_knobs()
        print(f"total {time.perf_counter() - t0:.1f} s")
        return

    if sys.argv[1:] == ["backbones"]:
        phase_swin(recs)
        phase_alt_backbones()
        phase_knobs()
        print(f"total {time.perf_counter() - t0:.1f} s")
        return
    probe_recs = phase_probes()
    if sys.argv[1:] == ["kernels"]:
        phase_auction(k4_rec, [])
        phase_adamw(k5_rec, k6_rec)
        phase_k7(k7_rec)
    else:
        masks_in_child()
        phase_eval(k1_rec, k2_rec)
        torch.cuda.empty_cache()
        phase_train(recs)
        torch.cuda.empty_cache()
        costs = phase_flagship(recs)
        torch.cuda.empty_cache()
        phase_auction(k4_rec, costs)
        del costs
        torch.cuda.empty_cache()
        phase_adamw(k5_rec, k6_rec)
        torch.cuda.empty_cache()
        phase_trainer(recs)
        torch.cuda.empty_cache()
        phase_bench()
        torch.cuda.empty_cache()
        phase_swin(recs)
        phase_alt_backbones()
        phase_knobs()
        torch.cuda.empty_cache()
        phase_variant_a(k7_rec)
        phase_variant_b()
        torch.cuda.empty_cache()
        phase_vit(recs)
        phase_weak_labels(recs)
        torch.cuda.empty_cache()
        phase_ddp(recs, smi)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": recs + probe_recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
