#!/usr/bin/env python
"""The PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (nothing is caught and carried
on):

1. card: require CUDA, print the card's name and power limit, set TF32 off;
2. build: compile every kernel of the serving and training paths from
   ``pevit_tpu_torch/ops/csrc`` with nvcc (one process per source, all at
   once) and print each instantiation's ptxas registers and spills;
3. kernels: hold the attention and fused-MLP forward kernels against their
   plain PyTorch versions on the card at the serving path's shapes and
   dtypes (and at the training batch of 128; attention also at the eval
   remainder of 8 images, at N = 577 (ViT-L/14 at 336 px, 16 heads, phase
   15's batch of 32) and at N = 1025 (8 images), both dtypes; fp32
   attention also at a ViT-B/16 backbone's batch of 64 images, N = 197),
   and time kernel, plain version and, where one
   exists, the PyTorch library call computing the same function.  Each
   kernel has a bf16 and an fp32 body; the dtype picks it (and in K1's
   bf16, N and hd pick one of its bodies, below).  The fused-MLP
   forward (K2) rows carry ``gemm_ms``, its two products as ``torch.matmul``
   calls, a yardstick the port never calls.  K1's and K2's fp32 bodies run
   three TF32 products on the tensor cores: every fp32 row of theirs, here
   and in the later phases, reports its max abs error against a float64 run
   of the plain version beside the plain fp32 version's (cuBLAS, TF32 off)
   and a TF32 control's (the plain version with ``allow_tf32`` for that
   call); the kernel's must be at most 4x the plain version's, and the
   control's above that wherever cuBLAS takes TF32 at the row's shapes (at
   every phase-3 row); and each one's bias, the mean error signed toward
   the float64 result, relative to it: the kernel's at most 4x the plain
   version's or half a float32 ulp, whichever is larger, so that a body
   whose accumulation truncates toward zero fails even where its max
   error passes.  fp32 rows carry both bounds, the FMA units' (ops /
   67 TFLOP/s) and three TF32 products' (3 ops / 495), and ``bound_ms`` is
   the lower (``bound_peak`` names it).  K1's rows carry ``ms`` and
   ``library_ms`` as device time (``attention_bodies.device_ms``: calls
   replayed from a CUDA graph) and ``call_ms``, one call's CUDA-event time,
   the host's issue included.  Then K1's persistent bf16 body (the
   launcher's at N <= 257 and hd <= 64) at every N <= 257 row of
   ``attention_bodies.SHAPES`` (N = 50, 197 and 257, batches 8 to 1280):
   held against the plain version and against the register body on the
   same inputs (2e-2, and every element within one bf16 ulp, at most 1%
   differing) and timed in turns with the register body, and at the
   serving batch with the body with the S tile in shared memory and the
   three-walk long body too (each from a copy of the source built beside
   the kernels with its ceilings set: the register body's raised to 257,
   the persistent body's set to 0, the shared-memory bodies' set to 0
   too), beside SDPA and the bound, and at batch 8 each body's host
   microseconds to enqueue a call;
3b. the fused-MLP backward kernel (K3) against its plain version and, in
   fp32, against torch autograd of the plain forward, at R = 6400 rows
   (ViT-B/32 batch 128) with C = 768 and 1024, bf16 and fp32, and in bf16
   at R = 5800 and 400 (phase 5's natural tail and eval remainder), timed
   beside its bound and beside ``gemm_ms``, its three products as bf16 (or
   fp32) ``torch.matmul`` calls; its fp32 body runs three TF32 products on
   the tensor cores as K1's and K2's do, and its fp32 rows go through the
   same float32-class check against a float64 run of the plain backward;
   K2 in bf16 at R = 5800 and 400 too; and the attention core's plain
   backward timed at N = 50, batch 128;
3c. the kernels at the shapes beyond ViT-B's, each against its plain
   version and timed beside SDPA or ``gemm_ms`` and its bound (fp32 rows
   through the float32-class check, which prints whether the TF32
   control engaged): K1 at head widths 20 (zero-padded to 24 in bf16), 32,
   80, 128 and 256, at N = 197 (64 images of 16 heads, logits of one
   spread at every width) in both dtypes and at N = 577 (32 images) in
   bf16, its long body; K2 and K3 at C = 192, 200, 384, 1280, 1408 with F
   = 4C and at (100, 300), which the wrappers zero-pad to whole 16-byte
   rows, both dtypes, at R = 32 x 257; and K1's shared-memory bodies (hd
   64) at N = 50, 197, 257, 577, 640, 641, 730 (20 heads, batches 64 and
   8), 768, 769 and 1025 (16 heads, batches 256 to 8): its four-stage
   ring, its short ring from 641, and past 768 the three-walk body, held
   against the plain version (2e-2, and every element within one bf16
   ulp, at most 1% differing, the rule of
   ``tests/test_torch_bf16_rounding.py``) and by that rule against the
   three-walk body on the same inputs, timed in turns with it beside
   SDPA;
4. serving: a full-width ViT-B/32 KAdaptation classifier (random weights
   from a seed, non-zero adaptation factors, random BN statistics, a
   100-class head fitted to 100 seeded prototype images) behind
   ``make_server`` -> ``MicroBatcher`` -> ``InferencePipeline`` answers
   ragged requests from 4 client threads; every forward must launch each
   kernel 12 times; logits must be finite and agree with the plain path on
   the same batch of noisy prototypes (fp32: within 1e-3 of the largest
   logit; bf16: the same top-1 on at least 99% of the images); images/s at
   batch 256 and request latency are printed;
5. training: the same frozen ViT-B/32 tower trains KAdaptation (seeded
   non-zero factors) through ``TaskStatic.from_config`` -> ``TrainTask`` ->
   ``train_trials`` in bf16 at batch 128: a 100-class 5-shot split of noisy
   prototypes (500 images: 3 full steps and a natural tail of 116) for two
   epochs of SGD with momentum 0.9 and dropout 0.5 on H, a 200-image val
   split evaluated after each epoch (3 chunks of 64 and a remainder of 8).
   Checks: K3 launches 12 per train step, K1 and K2 12 per train step and
   eval chunk; the loss and the logits are finite; the first step's
   gradients on the kernel path match the plain path (every kernel replaced
   by plain PyTorch under PyTorch's own autograd) on the same bundle and
   batch with dropout 0: fp32 every trainable leaf within 1e-3 of its
   largest |g|, bf16 cosine >= 0.99 per leaf, every KAdaptation leaf that
   the forward uses non-zero and finite (the v factors, unused by quirk 1,
   exactly zero on both paths); a whole fp32 run on both paths, in the same
   order, gives per-epoch val logits within 1e-3 of the largest logit.
   Train images/s at batch 128 are printed, bf16 and then fp32 (a
   KAdaptation run with dropout 0, its launches checked as above), the
   latter beside K3's share of a step (12 x its phase-3b fp32 ms);
6. the command: ``kronecker_adaptation_clip.main`` in this process, with
   the flags of ``scripts/kadapter_clip.sh`` (5-shot cifar-10, the LR x WD
   sweep on, the head initialised from text features, ``vitb32_CLIP.yaml``
   at full width and depth: 224 px, 12 x 768 vision and 12 x 512 text
   layers, 10 sweep epochs and 50 final ones), random weights and the
   synthetic cifar-10 split (no dataset or checkpoint is in the repo), and
   ``TPU.CHECKPOINT_DIR`` set.  Checks: the JSON and TXT artifacts have the
   reference's schema; ``predictions`` is (160, 10) with rows summing to 1;
   the sweep cache holds 42 to 90 trials and the chosen (lr, wd) is the
   reference walk's over those scores; the sweep's chunks hold at most
   TPU.SWEEP_PARALLEL_TRIALS trials and sum to its trials; K1, K2 and K3
   launch exactly as often as the sweep's and the final run's steps and
   eval chunks ask, one launch a block for each step and eval chunk of a
   whole chunk, at its trials times the images (each ``train_trials`` call
   recorded, ``call_batches``); the saved
   ``step_50.npz`` restores, bit for bit, the state the final run trained;
   the text features on the card match the same tower's on the CPU within
   1e-4 of their largest value; a second run replays from the completion
   sidecar, with no launch, in under a minute.  Times of the text features,
   the sweep (per trial), the final run (train images/s) and the whole
   phase are printed.  Then each kernel is held against its plain version,
   in the command's dtype, at every batch the command gave it (each
   train-step size for all three, each eval-chunk size for K1 and K2, the
   sweep's at its chunks' trial-folded batches), and timed there;
7. the other entry points, at full ViT-B/32 width and depth on synthetic
   cifar-10: a seeded CLIP written as an OpenAI-layout checkpoint (a
   ``torch.save`` pickle and the same inside ``{"state_dict": ...}``), each
   read by ``load_clip`` onto the card bit for bit (load seconds and file
   size printed); ``commands.zeroshot.main`` (K1 and K2 in fp32, 12 launches
   per 256-image chunk; image features within 1e-4 of the plain path's on
   the card; a second run replays the feature cache with no launch);
   ``commands.linear_probe.main`` with ``--no-tuning True`` and with
   ``--emulate-zeroshot True`` (K1 and K2 exactly as the steps and eval
   chunks ask, K3 never; the emulation takes no train step);
   ``commands.finetune.main`` with ``--no-tuning True`` and 2 + 1 epochs (a
   cut for the time limit; K1 only; first-step gradients of the visual tower
   kernel vs plain path, fp32 within 1e-3 of each leaf's largest |g|, bf16
   cosine >= 0.99, except ln_post's bias, whose gradient the head's BN
   cancels: rounding noise, held in fp32 within 1e-3 of the largest |g| of
   the tower; the pretrained tower and the text tower unchanged bit for bit
   after the run; trainable parameters = visual tower + head); each
   kernel held against its plain version at every batch each of these paths
   gave it; and the C++ resampler built with g++ on the card's host,
   resizing a seeded batch of non-square images to 224 (images/s printed);
8. the baselines, LoRA, the bottleneck adapter and Compacter, each on
   phase 4's frozen ViT-B/32 tower with seeded non-zero factors (LoRA's B
   is zero at init): the launches of one bf16 train step at batch 128 and
   of one batch-256 forward (LoRA K1 / K2 / K3 = 12 / 12 / 12 and
   12 / 12 / 0, the adapter and Compacter 12 / 0 / 0: their hook needs the
   bare MLP output, so their blocks never take the fused MLP); first-step
   gradients, kernel vs plain path, as phase 5's, bf16 with the head's
   BatchNorm off (with it on, reported only: see ``baseline_checks``;
   Compacter's frozen rule takes none on either path); a batch-256 bf16
   serving forward of a classifier
   fitted to that batch (one class per image: the scramble makes a row's
   features depend on its batch), top-1 agreement with the plain path
   >= 99%.
   Then each one's command in phase 6's output directory with its script's
   flags: ``lora_clip`` with the sweep (its own cache file beside phase 6's,
   which stays as it was, 42 to 90 trials, every one trained, and the
   reference walk's (lr, wd), its chunks of trials batched as phase 6's),
   ``adapter_clip`` and ``compacter_clip`` the final run only (a cut for
   the time limit); exact launches for their steps and chunks, the
   artifacts, ``n_trainable_params`` equal to the
   JAX package's count, Compacter's rule unchanged bit for bit; each kernel
   held against its plain version at every batch each path gave it;
9. the deployment path, on phase 4's tower with the head fitted to a
   served batch of 256 (phase 8's): ``serve_daemon`` started as a
   subprocess from phase 6's config and ``TPU.CHECKPOINT_DIR`` (exact
   padding); ``export_classifier`` in bf16 baked and weights-as-args, each
   fp and int8, traced on the card, and an fp32 baked one traced on the
   CPU, each saved as ``.pt2`` and loaded in one fresh ``python``
   subprocess that imports only the port, run on the card at batches 1, 8,
   37 and 256: logits equal to the in-process ``make_serving_fn`` at the
   same batch (bf16: top-1 agreement 1.0 and within 1e-3 of the largest
   logit; fp32 within 1e-5), 12 launches of K1 and K2 a call and none of
   K3 (the CPU-traced artifact launches them on the card); artifact MB;
   int8 against fp: the bundle's byte ratio > 3 and, on the reference
   test's construction at batch 256, top-1 agreement >= 15/16 and max
   relative logit error < 0.06; the daemon's ``/healthz`` and two answers
   to 37 images, equal to the in-process serving fn of the same config and
   trained state, then a clean SIGINT stop; the FLOP ledger of a batch-256
   serving forward and a batch-128 train step and the serving MFU of phase
   4's images/s; ``tools.serve_bench`` on the two program-only artifacts
   (fp, int8); each kernel held against its plain version at each batch;
10. the auxiliary backbones, each from its shipped model YAML at full
   width on synthetic cifar-10 with ``--no-tuning True`` and 2 + 1 epochs
   (a cut for the time limit); every backbone runs in float32 (on images
   normalised in the task's dtype), so its kernels run their fp32 bodies:
   a timm-layout ViT-B/16 checkpoint written from seeded tensors, loaded by
   ``get_model`` through TEST.MODEL_FILE bit for bit; ``linear_probe`` on
   ``mae_vitb16`` (the probe's GLOBAL_POOL override; 12 K1 launches a
   forward at N = 197, no K2: the erf-GELU blocks take the unfused MLP);
   its classifier exported with the backbone's ``forward_fn`` and run in a
   fresh process (logits within 1e-5 of the in-process forward, 12 K1 a
   call); ``finetune`` on ``vit_base_patch16_224`` from the checkpoint,
   with first-step gradients kernel vs plain path (fp32 within 1e-3 of
   each leaf's largest |g|, bf16 cosine >= 0.99; the final LayerNorm's
   bias, whose gradient the head's BN cancels, held as phase 7's ln_post
   bias; its scale, which the BN divides out up to its eps, in fp32
   within 2x the gap to the plain path, on its own size, that an
   attention in float64 rounded to float32 gives it in the same run, the
   witness of ``tools/fp32_grad_witness.py``);
   one 64-image forward each of ViT-B/32, DeiT-B/16 and MoCo-v3 B/16
   (features within 1e-4 of the plain path's, feature images/s);
   ``linear_probe`` on ``vitb32_DeCLIP`` with the text-initialised head
   (the DeCLIP tokenizer and text tower on the card within 1e-4 of a CPU
   copy; 12 K1 and 12 K2 a forward on the frozen tower); FILIP's dense
   features (feat_dim 49 x 256); one ``finetune`` step of ``vitb32_SLIP``
   (K1 only: its MLP weights train, so K2 is off); an OpenAI-layout RN50
   written from a seeded CLIP with live BatchNorm statistics, loaded bit
   for bit, ``zeroshot`` and ``linear_probe`` on it with no kernel launch
   (the attention pool is plain); a seeded CLIP-Swin-T checkpoint in the
   reference's layout loaded by ``get_model`` from ``clip_swin_tiny.yaml``
   bit for bit, a 64-image fp32 forward of it and of a ``cls_swin_tiny``
   classifier (features within 1e-4 of a CPU copy's on 8 images, feature
   images/s), ``linear_probe`` on it with the text head (text features
   card vs CPU within 1e-4), ``finetune`` on it (VISION.DROP_PATH_RATE
   0.1, which CLIP-Swin does not consume, as in the reference) and on
   ``cls_swin_tiny`` with DROP_PATH_RATE 0.1 (every train step through the
   stochastic forward): no Swin path launches a kernel (window attention
   and the MLP are plain, as in the reference); each kernel held against
   its plain version at every batch each path gave it;
11. streaming, a train split in host memory (``train/streaming.py``):
   (a) 650 train and 160 val images of phase 4's prototypes, fp32, dropout
   0, ``TPU.MAX_DEVICE_DATA_GB`` below the split, 2 trials x 2 epochs
   through ``train_trials`` (one batched step a streamed batch for both),
   against each trial's preloaded serial run handed the streamed orders:
   every epoch's val logits within 1e-5 of the largest (the gap printed),
   exact launches, the split's bytes crossing once an epoch for both
   trials; (b) 28,000 images (4.21 GB) at the default 4.0 GB limit on a
   seeded ViT-B/32 tower of 6 blocks (a cut for the time limit),
   bf16, batch 128, one trial after a warm-up: exact launches, the split's
   bytes once, the card's peak allocation during the epoch below the
   split's size, streamed train images/s beside the preloaded path's on
   the same split held on the card, and each one's device idle share from
   a CUDA-only ``torch.profiler`` trace of each side's second epoch; (c)
   ``kronecker_adaptation_clip`` with phase 6's flags and ``--no-tuning
   True``, the train and test splits in host memory and the val split on
   the card, so the final run merges train and val on the host and
   streams: the artifacts' schema and exact launches; each kernel held
   against its plain version at every batch each path gave it;
12. trial batches, a sweep chunk's trials as one batch through
   ``train_trials`` on phase 4's tower and phase 5's data (500 train
   images, the first 160 val): (a) 4 KAdaptation trials of distinct (lr,
   wd), fp32, dropout 0, 2 epochs, batched and through
   ``_train_trials_serial``: every (trial, epoch) val logit and each
   trial's trained parameters within 1e-5 of the serial path's largest;
   (b) a chunk of 8 (TPU.SWEEP_PARALLEL_TRIALS' default) in bf16 at batch
   128, dropout 0.5, 2 epochs, after a warm-up chunk, serial, batched,
   batched, serial: seconds per trial of each path (the mean of its two
   runs), each one's device idle share from a CUDA-only ``torch.profiler``
   trace of one more run, the card's peak allocation of a batched chunk,
   launches exactly 12 a step and an eval chunk for the whole chunk, each
   trial's gaps to the serial path and both paths' best scores (reported,
   not held: in bf16 another delta-GEMM algorithm can move a trial);
   (c) the process capped (``torch.cuda.set_per_process_memory_fraction``)
   at 3/4 of (b)'s peak above what it holds: ``sweep._run_stage`` on 8
   trials splits the chunk that runs out of memory, logs the split and
   returns 8 finite scores; the cap is lifted; (d) each kernel held against
   its plain version at every trial-folded batch (a and b) with its
   launches;
13. trial axis II, full fine-tuning and the auxiliary backbones trained as
   one batch a chunk (each trial's tower stacked, a frozen backbone shared),
   on phase 5's data cut to 256 train images (8 steps of 32 an epoch), 2
   epochs: (a) full fine-tuning of phase 4's ViT-B/32 tower, a bf16 chunk
   of 8 after a warm-up chunk, serial, batched, batched, serial: seconds a
   trial of each path, each one's device idle share from a CUDA-only
   profile of one more run, the card's peak allocation of a batched chunk,
   K1 exactly 12 a step and an eval chunk for the whole chunk; then an fp32
   chunk of 4, every (trial, epoch) val logit and each trial's trained
   parameters batched within 1e-5 of the serial path's largest, and the
   task's tower unchanged; (b) the same fp32 check for the timm ViT-B/16
   under full fine-tuning, a chunk of 4 (K1's fp32 body at 128 images, N =
   197), and the DeCLIP ViT-B/32 linear probe, a chunk of 8 on the shared
   tower (K1 and K2 fp32, once a block a step and an eval chunk), on the
   first 64 val images; (c) Swin-T with DROP_PATH_RATE 0.1, the linear
   probe and full fine-tuning, chunks of 4, fp32: every train step through
   the stochastic forward and batched within 1e-5 of serial (each trial's
   draws from its own generators); the plain path, no kernel launch; each
   kernel held against its plain version at every trial-folded batch;
14. the mesh (``parallel``, ``utils.dist``): (a) a world of one over NCCL
   through the launcher's variables in this process: one ``all_reduce`` on
   the card, then a bf16 KAdaptation chunk of 2 through ``train_trials``
   and its mesh plan, bit for bit the chunk run before joining; (b) a
   2-rank gloo world on the one card (this script run twice with
   ``--mesh-rank``, both ranks on ``cuda:0``), at full ViT-B/32 width, 1
   epoch each: a chunk of 8 KAdaptation trials cut 4 + 4 over "trial" in
   fp32 (held within 1e-5 of this process's chunk without a world) and in
   bf16 (dropout 0.5, gaps reported); the fp32 final run (dropout 0.5) at
   batch 128 over "data", 64 + 64 rows a step, its natural tail of 44 and
   eval remainder of 36 whole on each rank (within 1e-5); an fp32 LoRA
   step at (data 1, model 2), each rank's attention on 6 heads and the MLP
   kernels on gathered weights (within 1e-5); a data-parallel serving call
   from a bf16 mesh artifact of width 2 at batch 256 (top-1 1.0 and within
   1e-3 of the largest logit of the serving fn); each rank's launches
   printed and held to its batches, the ranks' results equal; each kernel
   held against its plain version at every batch a rank gave it;
15. CLIP ViT-L/14 at 336 px (N = 577), at full width and depth (24 x 1024,
   16 heads): a seeded OpenAI-layout state dict with a 577-row positional
   embedding (1.7 GB, both towers) written and read by ``load_clip`` onto
   the card (the spec from its keys, input_resolution 336; every tensor
   bit for bit); the bf16 KAdaptation classifier (a 64-class head fitted
   to the seeded images it serves, one class each, as phase 8's, refitted
   at each batch to the images' features in batches of that size)
   through ``make_serving_fn`` on uint8 images at batches 1, 8 and 64:
   24 K1 and 24 K2 launches a forward, logits and top-1 against the
   plain path (phase 4's limits), images/s at 64 and
   K1's share of that forward from a CUDA-only profile; a bf16 KAdaptation
   run through ``train_trials`` at batch 32 (96 train images, 3 steps, and
   32 val images, one eval chunk; dropout 0.5): 24 K1, K2 and K3 launches
   a step, K1 and K2 an eval chunk, the card's peak allocation, train
   images/s, first-step fp32 gradients against the plain path at phase
   5's limits; each kernel held against its plain version at every batch
   each path gave it;
16. ViT-H/14 at full width and depth from seeded weights, each model
   built from the MODEL.SPEC a user would give it: (a) CLIP ViT-H/14
   (vision 1280 x 32 layers of 20 heads of 64, patch 14, N = 257; text
   1024 x 24): the bf16 KAdaptation classifier served as phase 15's at
   batches 1, 8 and 64 (32 K1 and 32 K2 a forward, top-1 agreement with
   the plain path 1.0, images/s, K1's and K2's shares of a forward) and
   trained at batch 32 (3 steps, one eval chunk; 32 K1, K2 and K3 a step;
   peak allocation, train images/s, each kernel's share of a step from a
   CUDA-only profile, fp32 first-step gradients within 1e-3 of each leaf's
   largest |g|); (b) MAE ViT-H/14 (EMBED_DIM 1280, DEPTH 32, NUM_HEADS 16:
   heads of 80, the global pool) through ``get_model``: a 64-image fp32
   feature forward (32 K1 a forward on its fp32 body, no K2) within 1e-4
   of the plain path's and its feature images/s, then one
   ``full_finetune`` step at batch 16 through ``train_trials`` with
   first-step gradients held as phase 10's ViT-B/16 finetune (the float64
   witness for the final LayerNorm's scale included); (c) CLIP ViT-H/14
   at 378 px (DFN5B-CLIP-ViT-H-14-378's resolution: N = 730, 20 heads of
   64 by the reference's rule) on 16a's tower with a fresh seeded 730-row
   positional embedding, served and trained as 16a, every K1 launch on
   the short-ring body (the launch plan at every batch, and the CUDA-only
   profiles of a forward and of a train step, whose K1 time is all that
   body's), fp32 first-step gradients at 16 images; each kernel held
   against its plain version at every batch each path gave it;
17. CLIP ViT-B/16 (``vitb16_CLIP.yaml``: 12 x 768, patch 16, N = 197) at
   full width and depth from seeded weights, in bf16, every K1 launch on
   the persistent body (the launch plan at every batch, and the CUDA-only
   profiles of a forward and of a train step, whose K1 time is all that
   body's): the KAdaptation classifier served at batch 256 with its head
   fitted to the served batch (12 K1 and 12 K2 a forward, top-1 agreement
   with the plain path, images/s, K1's share of a forward) and trained at
   batch 128 (3 steps, one eval chunk of 64; 12 K1, K2 and K3 a step, peak
   allocation, train images/s, each kernel's share of a step, fp32
   first-step gradients at 16 images within 1e-3 of each leaf's largest
   |g|); serving and train images/s and K1's share of a forward with the
   persistent body and with the register body (phase 3's aid) in turns;
   each kernel held against its plain version at every batch each path
   gave it;
18. report: one ``{"kernels": [...]}`` line: launches from phases 6 to 17,
   summed, by path and by body (each path's counts are zeroed just before
   it and read just after; phase 9's and the exported MAE probe's are the
   fresh process's, reported by it), the other numbers at the batch that
   launched the kernel most, every path's batches (and the body each ran)
   under ``by_shape``, every body's launches and numbers under ``bodies``
   (a body no path ran, with 3c's, or, for the register body, with phase
   3's rows at the serving batch); then the ``{"ok": true, ...}`` line
   last.

Needs one card; imports only the port, torch, numpy and the standard library.

``python3 chip_smoke.py --mesh-cards`` (on a host of several cards, none of
the phases above) runs the KAdaptation command with its sweep in fp32 once
in this process and once in a world of one rank a card over NCCL, and
holds every sweep score, the chosen (lr, wd) and the test predictions
(within 1e-5 of the largest) to the single process's.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import importlib
import io
import json
import logging
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

SERVE_BATCH = 256
TRAIN_BATCH = 128
# phase 5's ragged batches: 500 train images = 3 x 128 + a natural tail of
# 116; 200 val images = 3 chunks of 64 + a remainder of 8
TRAIN_TAIL, EVAL_REMAINDER = 116, 8


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def entry_tag(entry: str) -> str:
    """A compiled kernel's name and template arguments, from ptxas's mangled
    entry name, e.g. ``attention_fwd_bf16<17>`` or ``ln_rows_bf16<24>``."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", entry)
    if m is None:
        return entry.strip()
    name = entry[m.end():m.end() + int(m.group(1))]
    rest = entry[m.end() + len(name):]
    if not rest.startswith("I"):
        return name
    targs = rest[1:rest.index("EE") + 1]
    types = {"13__nv_bfloat16": "bf16", "f": "float", "t": "uint16", "j": "uint32"}
    args = [types[t] for t in re.findall(r"^(13__nv_bfloat16|f|t|j)", targs)]
    literals = [("true" if v == "1" else "false") if kind == "b" else v
                for kind, v in re.findall(r"L([ib])(\d+)", targs)]
    return f"{name}<{', '.join(args + literals)}>"


def ptxas_summary(name: str, log: str) -> list:
    """One line per compiled instantiation: kernel, registers, spills."""
    out, entry, spills = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "Used" in line and "registers" in line:
            out.append(f"ptxas {name} {entry_tag(entry)}: {line.split(':', 1)[1].strip()}; "
                       f"{spills}")
        elif "spill stores" in line:
            spills = line.strip()
    return out


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def card_peaks():
    """This card's published peaks, from the port's one table
    (``pevit_tpu_torch.utils.flops.CHIP_SPECS``); a card it lacks fails."""
    from pevit_tpu_torch.utils.flops import chip_peaks

    peaks = chip_peaks(torch.cuda.get_device_name(0))
    if peaks.hbm_gb_s is None:
        raise RuntimeError(f"no published peaks for {torch.cuda.get_device_name(0)}")
    return peaks


def _bound(n_bytes: float, n_ops: float, tflops: float) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over ``tflops``."""
    peaks = card_peaks()
    t_bytes = n_bytes / (peaks.hbm_gb_s * 1e9) * 1e3
    t_ops = n_ops / (tflops * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_fields(n_bytes: float, n_ops: float, dtype) -> dict:
    """The card's least time for the work, ``bound_ms`` / ``bound_by``, and
    the peak it is read against, ``bound_peak``.  bf16: the tensor cores'
    bf16 peak.  float32: the lower of two bounds, both given, the FMA units'
    fp32 peak (ops / 67 TFLOP/s) and three TF32 products on the tensor
    cores (3 ops / 495), as K1's and K2's fp32 bodies run them."""
    peaks = card_peaks()
    if dtype != torch.float32:
        bms, by = _bound(n_bytes, n_ops, peaks.bf16_tflops)
        return {"bound_ms": bms, "bound_by": by, "bound_peak": "bf16"}
    both = {"tf32x3": _bound(n_bytes, 3 * n_ops, peaks.tf32_tflops),
            "fma": _bound(n_bytes, n_ops, peaks.fp32_tflops)}
    peak = min(both, key=lambda name: both[name][0])
    return {"bound_ms": both[peak][0], "bound_by": both[peak][1], "bound_peak": peak,
            "bound_fma_ms": both["fma"][0], "bound_tf32x3_ms": both["tf32x3"][0]}


@contextlib.contextmanager
def tf32_products():
    """PyTorch's float32 matrix products in TF32, for one call (the TF32
    control of :func:`fp32_class`), then restored."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


FP32_CLASS_FACTOR = 4.0
# half a float32 ulp, relative: the floor of the bias bound of fp32_class
FP32_HALF_ULP = 2.0 ** -24


def fp32_class(name: str, got, plain, plain64) -> dict:
    """The float32-class check of a float32 body against a float64 run of
    the plain version, beside the plain float32 version (cuBLAS, TF32 off):

    * max abs error (``err_f64``): at most FP32_CLASS_FACTOR x the plain
      version's.  The TF32 control (the plain version with TF32 products)
      must exceed that bound, which shows that the check tells float32 from
      TF32, wherever cuBLAS takes TF32 for the control's shapes
      (``tf32_engaged``: its result differs from the plain float32 one); at
      some small or odd shapes cuBLAS runs float32 kernels whatever
      ``allow_tf32`` says, and the control is then the plain version itself.
      Phase 3's rows must all have it engaged.
    * bias (``bias_f64``): the mean error signed toward the reference,
      sum((t - want) * want) / sum(want^2), negative where the results sit
      toward zero, as a truncating accumulation leaves them.  Its size is
      at most FP32_CLASS_FACTOR x the plain version's or half a float32 ulp
      (FP32_HALF_ULP), whichever is larger: a correctly rounded sum reads
      ~0, so a multiple of it alone would refuse any body that does not
      round to nearest."""
    want = plain64()
    err = lambda t: (t.double() - want).abs().max().item()
    bias = lambda t: ((t.double() - want) * want).sum().item() / want.square().sum().item()
    base = plain()
    with tf32_products():
        control = plain()
    row = {"err_f64": err(got), "plain_err_f64": err(base), "tf32_err_f64": err(control),
           "tf32_engaged": not torch.equal(control, base),
           "bias_f64": bias(got), "plain_bias_f64": bias(base), "tf32_bias_f64": bias(control)}
    bound = FP32_CLASS_FACTOR * row["plain_err_f64"]
    if not row["err_f64"] <= bound:
        raise AssertionError(f"{name}: kernel error vs float64 {row['err_f64']} exceeds "
                             f"{FP32_CLASS_FACTOR} x the plain float32 version's: {row}")
    if row["tf32_engaged"] and not row["tf32_err_f64"] > bound:
        raise AssertionError(f"{name}: the TF32 control's error vs float64 does not exceed "
                             f"the bound, so the check cannot tell float32 from TF32: {row}")
    bias_bound = max(FP32_CLASS_FACTOR * abs(row["plain_bias_f64"]), FP32_HALF_ULP)
    if not abs(row["bias_f64"]) <= bias_bound:
        raise AssertionError(f"{name}: kernel bias vs float64 {row['bias_f64']} exceeds "
                             f"{bias_bound} (the larger of {FP32_CLASS_FACTOR} x the plain "
                             f"float32 version's and half a float32 ulp): {row}")
    return row


def attention_f64(q, k, v):
    """The plain attention in float64, on (B, N, H, hd)."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q.double(), k.double())
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1), v.double())


def fused_mlp_f64(x, ln_s, ln_b, wfc, bfc, wproj, bproj, eps: float = 1e-5):
    """The plain fused residual MLP in float64."""
    x64 = x.double()
    mean = x64.mean(-1, keepdim=True)
    var = (x64 - mean).square().mean(-1, keepdim=True)
    u = (x64 - mean) * torch.rsqrt(var + eps) * ln_s.double() + ln_b.double()
    h = u @ wfc.double() + bfc.double()
    m = (h * torch.sigmoid(1.702 * h)) @ wproj.double() + bproj.double()
    return x64 + m


def fused_mlp_bwd_f64(dy, x, ln_s, ln_b, wfc, bfc, wproj, eps: float = 1e-5):
    """The plain fused-MLP backward (dx) in float64."""
    x64, scale = x.double(), ln_s.double()
    mean = x64.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x64 - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (x64 - mean) * rstd
    h = (xhat * scale + ln_b.double()) @ wfc.double() + bfc.double()
    sig = torch.sigmoid(1.702 * h)
    dh = (dy.double() @ wproj.double().T) * (sig * (1.0 + 1.702 * h * (1.0 - sig)))
    dxhat = (dh @ wfc.double().T) * scale
    mdx, mdxx = dxhat.mean(-1, keepdim=True), (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - mdx - xhat * mdxx) * rstd + dy.double()


def check_close(name, got, want, rtol, atol) -> float:
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with plain version, max abs err {err}")
    return err


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_attention(gen, dtype, n, batch=SERVE_BATCH, heads: int = 12, hd: int = 64):
    from pevit_tpu_torch.ops.attention import attention_fwd, attention_ref, launch_plan
    from pevit_tpu_torch.tools.attention_bodies import device_ms

    B, H = batch, heads
    # logits of one spread (std 0.5) at every head width: q and k entries of
    # std (0.25 / hd) ** 0.25, 0.25 at hd 64
    qk = (0.25 / hd) ** 0.25
    q, k, v = (torch.randn(B, n, H, hd, device="cuda", generator=gen) * s
               for s in (qk, qk, 1.0))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    t = lambda x: x.transpose(1, 2)
    plain = lambda: t(attention_ref(t(q), t(k), t(v)))
    got, want = attention_fwd(q, k, v), plain()
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)
    err = check_close(f"attention_fwd N={n} {dtype}", got, want, rtol, atol)
    accuracy = {}
    if dtype == torch.float32:
        accuracy = fp32_class(f"attention_fwd N={n}", got, plain, lambda: attention_f64(q, k, v))
    qh, kh, vh = (t(x).contiguous() for x in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
    esize = torch.finfo(dtype).bits // 8
    call = lambda: attention_fwd(q, k, v)
    return {"shape": f"B*H={B}*{H} N={n} hd={hd}", "dtype": str(dtype).split(".")[-1],
            "body": launch_plan(B, n, H, hd, dtype).body,
            "max_abs_err": err, **accuracy, "ms": device_ms(call), "call_ms": time_ms(call),
            "plain_ms": time_ms(plain), "library_ms": device_ms(library),
            **bound_fields(4 * B * H * n * hd * esize, 4 * B * H * n * n * hd, dtype)}


def k1_bodies(tmp: Path) -> dict:
    """Phase 3's aids, K1 built from copies of its source with ``constexpr``
    ceilings set otherwise (``attention_bodies.source_variant``), so that a
    body can be timed where the launcher runs another: its bf16 shapes at
    hd <= 64 up to 257 tokens sent to the register body ("regs":
    ``MAX_SEQ_REGS`` 257), to the shared-memory body up to its longest N
    ("smem": ``TMA_MAX_SEQ`` 0), and every bf16 shape to the three-walk
    long body ("long": the shared-memory ceilings 0 too)."""
    from pevit_tpu_torch.tools.attention_bodies import source_variant

    return {"regs": source_variant(tmp, "regs", MAX_SEQ_REGS=257),
            "smem": source_variant(tmp, "smem", MAX_SEQ_REGS=0, TMA_MAX_SEQ=0),
            "long": source_variant(tmp, "long", MAX_SEQ_REGS=0, TMA_MAX_SEQ=0, SMEM_MAX_SEQ=0,
                                   SMEM2_MAX_SEQ=0)}


def qkv_bf16(gen, batch, n, heads, hd):
    """bf16 q, k, v (B, N, H, hd) whose logits spread with std 0.5 at every
    head width."""
    qk = (0.25 / hd) ** 0.25
    return tuple((torch.randn(batch, n, heads, hd, device="cuda", generator=gen) * s).bfloat16()
                 for s in (qk, qk, 1.0))


def bf16_ulp_diff(got, old) -> dict:
    """``got`` against ``old`` by the same-rounding rule of
    ``tests/test_torch_bf16_rounding.py``: every element within one bf16 ulp
    at ``old``'s largest magnitude, at most 1% of them differing."""
    got, old = got.float(), old.float()
    ulp = 2.0 ** (math.floor(math.log2(old.abs().max().item())) - 7)
    diff = (got - old).abs()
    return {"max_diff_ulps": diff.max().item() / ulp,
            "share_differing": (diff > 0).float().mean().item()}


def same_rounding(what: str, got, against: dict) -> dict:
    """:func:`bf16_ulp_diff` of ``got`` against each of ``against``
    ({name: tensor}); raises where one is off the rule."""
    same = {name: bf16_ulp_diff(got, old) for name, old in against.items()}
    for name, d in same.items():
        if d["max_diff_ulps"] > 1 or d["share_differing"] > 0.01:
            raise AssertionError(f"{what}: against the {name} version {d}")
    return same


def tma_rows() -> list:
    """Phase 3's rows of K1's persistent body: every (N, heads, batch) of
    ``attention_bodies.SHAPES`` at hd 64 and N <= TMA_MAX_SEQ."""
    from pevit_tpu_torch.ops.attention import TMA_MAX_SEQ
    from pevit_tpu_torch.tools.attention_bodies import SHAPES

    return [(n, heads, b) for n, hd, heads, batches in SHAPES if hd == 64 and n <= TMA_MAX_SEQ
            for b in batches]


def enqueue_us(fn, reps: int = 200) -> float:
    """The host's mean microseconds to enqueue one call of ``fn`` (the
    card idle before the first), the card's work left out."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def time_bf16_bodies(gen, bodies: dict, n, batch=SERVE_BATCH, heads: int = 12,
                     others: tuple = ()) -> dict:
    """K1's bf16 bodies at one N <= TMA_MAX_SEQ, hd 64: the persistent body
    (what the launcher runs there) held against the plain version (2e-2,
    and :func:`same_rounding`) and by :func:`same_rounding` against the
    register body ("regs" of ``bodies``) on the same inputs, and timed in
    turns with it (persistent, regs, ``others``..., the same backwards; the
    mean of each one's two :func:`device_ms`), each aid of ``others``
    ("smem", "long") held against the plain version too; beside SDPA, the
    bound, a single call's ``time_ms`` (``call_ms``, the host's issue
    included) and, at batch 8, each of the persistent and the register
    body's host microseconds to enqueue a call."""
    from pevit_tpu_torch.ops.attention import attention_fwd, attention_ref, launch_plan
    from pevit_tpu_torch.tools.attention_bodies import device_ms, launching

    q, k, v = qkv_bf16(gen, batch, n, heads, 64)
    t = lambda x: x.transpose(1, 2)
    want = t(attention_ref(t(q), t(k), t(v)))
    plan = launch_plan(batch, n, heads, 64, torch.bfloat16)
    what = f"attention_fwd {plan.body}<{plan.keys}> N={n} batch {batch}"
    got = attention_fwd(q, k, v)
    row = {"shape": f"B*H={batch}*{heads} N={n} hd=64", "dtype": "bfloat16", "body": plan.body,
           "keys": plan.keys, "max_abs_err": check_close(what, got, want, 2e-2, 2e-2)}
    outs = {}
    for name in ("regs", *others):
        with launching(bodies[name]):
            outs[name] = attention_fwd(q, k, v)
        row[f"{name}_max_abs_err"] = check_close(f"attention_fwd {name} body N={n}",
                                                 outs[name], want, 2e-2, 2e-2)
    row["ulps_against"] = same_rounding(what, got, {"plain": want, "regs": outs["regs"]})
    order = ["tma", "regs", *others]
    turns = {name: [] for name in order}
    for name in order + order[::-1]:
        with launching(bodies[name]) if name in bodies else contextlib.nullcontext():
            turns[name].append(device_ms(lambda: attention_fwd(q, k, v)))
    qh, kh, vh = (t(x).contiguous() for x in (q, k, v))
    row.update({"ms": statistics.mean(turns["tma"]),
                **{f"{name}_ms": statistics.mean(turns[name]) for name in order[1:]},
                "turns_ms": turns, "regs_over_tma": statistics.mean(turns["regs"])
                / statistics.mean(turns["tma"]),
                "call_ms": time_ms(lambda: attention_fwd(q, k, v)),
                "plain_ms": time_ms(lambda: t(attention_ref(t(q), t(k), t(v))), reps=5),
                "library_ms": device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, scale=1.0)),
                **bound_fields(8 * batch * heads * n * 64, 4 * batch * heads * n * n * 64,
                               torch.bfloat16)})
    if batch == 8:
        row["enqueue_us"] = enqueue_us(lambda: attention_fwd(q, k, v))
        with launching(bodies["regs"]):
            row["regs_enqueue_us"] = enqueue_us(lambda: attention_fwd(q, k, v))
    return row


def check_fused_mlp(gen, dtype, c, rows, f: int = 0):
    from pevit_tpu_torch.ops.fused_mlp import fused_mlp_fwd, fused_mlp_residual_ref

    f = f or 4 * c
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    x = r(rows, c).to(dtype)
    ln_s, ln_b = 1 + 0.1 * r(c), 0.1 * r(c)
    wfc, bfc = (r(c, f) * c ** -0.5).to(dtype), (0.1 * r(f)).to(dtype)
    wproj, bproj = (r(f, c) * f ** -0.5).to(dtype), (0.1 * r(c)).to(dtype)
    args = (x, ln_s, ln_b, wfc, bfc, wproj, bproj)
    got, want = fused_mlp_fwd(*args), fused_mlp_residual_ref(*args)
    torch.cuda.synchronize()
    # fp32: the 3072/4096-long sums run in another order than cuBLAS's
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    err = check_close(f"fused_mlp_fwd C={c} {dtype}", got, want, rtol, atol)
    accuracy = {}
    if dtype == torch.float32:
        accuracy = fp32_class(f"fused_mlp_fwd R={rows} C={c}", got,
                              lambda: fused_mlp_residual_ref(*args), lambda: fused_mlp_f64(*args))
    esize = torch.finfo(dtype).bits // 8
    n_bytes = (2 * rows * c + 2 * c * f + f + c) * esize + 2 * c * 4
    # a yardstick only: K2's two products as torch.matmul calls on operands
    # of the same shapes and dtype (no one PyTorch call computes K2), drawn
    # from the default generator so that the later checks' draws from
    # ``gen`` do not depend on them
    u = torch.randn(rows, c, device="cuda").to(dtype)
    g = torch.randn(rows, f, device="cuda").to(dtype)
    gemms = lambda: (u @ wfc, g @ wproj)
    return {"shape": f"R={rows} C={c} F={f}", "dtype": str(dtype).split(".")[-1],
            "body": "f32" if dtype == torch.float32 else "bf16",
            "max_abs_err": err, **accuracy, "ms": time_ms(lambda: fused_mlp_fwd(*args), reps=5),
            "plain_ms": time_ms(lambda: fused_mlp_residual_ref(*args), reps=5),
            "library_ms": None, "gemm_ms": time_ms(gemms, reps=5),
            **bound_fields(n_bytes, 4 * rows * c * f, dtype)}


def check_fused_mlp_bwd(gen, dtype, c, rows, f: int = 0):
    """K3 against its plain backward (same rounding points) and, in fp32,
    against torch autograd of the plain forward and through
    :func:`fp32_class` against a float64 run of the plain backward."""
    from pevit_tpu_torch.ops.fused_mlp import (fused_mlp_bwd, fused_mlp_bwd_ref,
                                               fused_mlp_residual_ref)

    f = f or 4 * c
    r = lambda *s: torch.randn(*s, device="cuda", generator=gen)
    x, dy = r(rows, c).to(dtype), r(rows, c).to(dtype)
    ln_s, ln_b = 1 + 0.1 * r(c), 0.1 * r(c)
    wfc, bfc = (r(c, f) * c ** -0.5).to(dtype), (0.1 * r(f)).to(dtype)
    wproj, bproj = (r(f, c) * f ** -0.5).to(dtype), (0.1 * r(c)).to(dtype)
    args = (dy, x, ln_s, ln_b, wfc, bfc, wproj)
    got, want = fused_mlp_bwd(*args), fused_mlp_bwd_ref(*args)
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    err = check_close(f"fused_mlp_bwd C={c} {dtype}", got, want, rtol, atol)
    row = {"shape": f"R={rows} C={c} F={f}", "dtype": str(dtype).split(".")[-1],
           "body": "f32" if dtype == torch.float32 else "bf16", "max_abs_err": err}
    if dtype == torch.float32:
        xg = x.clone().requires_grad_()
        y = fused_mlp_residual_ref(xg, ln_s, ln_b, wfc, bfc, wproj, bproj)
        (auto,) = torch.autograd.grad(y, xg, dy)
        row["max_abs_err_autograd"] = check_close(f"fused_mlp_bwd C={c} vs autograd",
                                                  got, auto, rtol, atol)
        row.update(fp32_class(f"fused_mlp_bwd R={rows} C={c}", got,
                              lambda: fused_mlp_bwd_ref(*args),
                              lambda: fused_mlp_bwd_f64(*args)))
    esize = torch.finfo(dtype).bits // 8
    n_bytes = (3 * rows * c + 2 * c * f + f) * esize + 2 * c * 4
    # a yardstick only: K3's three products as torch.matmul calls on operands
    # of the same shapes and dtype (no one PyTorch call computes K3)
    u, dh = r(rows, c).to(dtype), r(rows, f).to(dtype)
    gemms = lambda: (u @ wfc, dy @ wproj.T, dh @ wfc.T)
    return {**row, "ms": time_ms(lambda: fused_mlp_bwd(*args), reps=5),
            "plain_ms": time_ms(lambda: fused_mlp_bwd_ref(*args), reps=5),
            "library_ms": None, "gemm_ms": time_ms(gemms, reps=5),
            **bound_fields(n_bytes, 6 * rows * c * f, dtype)}  # the three GEMMs it runs


def time_attention_bwd(gen, dtype, n, batch):
    """The attention core's backward, plain PyTorch as in the reference."""
    from pevit_tpu_torch.ops.attention import attention_bwd_ref

    H, hd = 12, 64
    q, k, v, g = (torch.randn(batch, n, H, hd, device="cuda", generator=gen).to(dtype)
                  for _ in range(4))
    esize = torch.finfo(dtype).bits // 8
    return {"shape": f"B*H={batch}*{H} N={n} hd={hd}", "dtype": str(dtype).split(".")[-1],
            "plain_ms": time_ms(lambda: attention_bwd_ref(q, k, v, g)),
            **bound_fields(7 * batch * n * H * hd * esize, 10 * batch * H * n * n * hd, dtype)}


# 3c's shapes: K1 at head widths 20 (zero-padded to 24 in bf16), 32, 80 (MAE
# ViT-H/14), 128 and 256, at N = 197 (64 images of 16 heads) in both dtypes
# and at N = 577 (32 images) in bf16, its long body; K2 and K3 at the model
# widths of ViT-Ti (192), ViT-S (384), ViT-H (1280) and ViT-g (1408) with F
# = 4C, a tail case (200, 800) that fills no tile, and a width that fills
# no 16-byte chunk (100, 300, zero-padded), both dtypes, at R = 32 x 257
# (phase 16's training batch)
SHAPE_HEAD_DIMS = (20, 32, 80, 128, 256)
SHAPE_WIDTHS = ((192, 768), (200, 800), (384, 1536), (1280, 5120), (1408, 5632), (100, 300))
SHAPE_ROWS = 32 * 257


def check_kernel_shapes(gen) -> dict:
    """3c: every kernel against its plain version at the shapes beyond
    ViT-B's (``SHAPE_HEAD_DIMS``, ``SHAPE_WIDTHS``), timed beside SDPA or
    ``gemm_ms`` and its bound; fp32 rows through :func:`fp32_class`."""
    table = {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}
    for hd in SHAPE_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            table["attention_fwd"].append(check_attention(gen, dtype, 197, AUX_BATCH, 16, hd))
        table["attention_fwd"].append(check_attention(gen, torch.bfloat16, 577, 32, 16, hd))
    for c, f in SHAPE_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            table["fused_mlp_fwd"].append(check_fused_mlp(gen, dtype, c, SHAPE_ROWS, f))
            table["fused_mlp_bwd"].append(check_fused_mlp_bwd(gen, dtype, c, SHAPE_ROWS, f))
    return table


# 3c's rows of K1's shared-memory bodies (hd 64), (N, heads, batch): the
# lengths of ViT-B/32 (50), ViT-B/16 (197), ViT-L/14 (257), ViT-L/14 at 336
# px (577), CLIP ViT-H/14 at 378 px (730, 20 heads, at phase 16c's largest
# and a small batch) and 1025; the longest N of each ring and one more (the
# short ring's first, the three-walk body's first)
SMEM_SHAPES = ((50, 16, 256), (197, 16, 64), (257, 16, 64), (577, 16, 32), (640, 16, 16),
               (641, 16, 16), (730, 20, 64), (730, 20, 8), (768, 16, 16), (769, 16, 16),
               (1025, 16, 8))


def smem_body_at(n: int, heads: int, batch: int) -> str:
    """The body the "smem" aid runs at (N, hd 64): the launcher's, but the
    shared-memory body where the launcher runs the persistent body."""
    from pevit_tpu_torch.ops.attention import TMA_MAX_SEQ, launch_plan

    return "bf16_smem" if n <= TMA_MAX_SEQ else launch_plan(batch, n, heads, 64,
                                                            torch.bfloat16).body


def check_smem_body(gen, bodies: dict) -> list:
    """3c: K1's shared-memory bodies ("smem" of ``bodies``, which also takes
    the shapes the launcher gives the register body) at hd 64 and each shape
    of ``SMEM_SHAPES``, held against the plain version (2e-2, and by
    :func:`bf16_ulp_diff`, which ``attention_ref``'s rounding point makes
    exact up to the sum's order) and by :func:`bf16_ulp_diff` against the
    three-walk body ("long") on the same inputs, and timed in turns (smem,
    long, long, smem; the mean of each one's two :func:`device_ms`) beside
    the plain version, SDPA (``device_ms`` too), its bound and a single
    call's ``time_ms`` (``call_ms``, the host's issue included);
    ``launcher_body`` names the body the launcher runs at the shape.  Past
    the short ring's limit both run the three-walk body: the rows show the
    route."""
    from pevit_tpu_torch.ops.attention import attention_fwd, attention_ref, launch_plan
    from pevit_tpu_torch.tools.attention_bodies import device_ms, launching

    rows = []
    t = lambda x: x.transpose(1, 2)
    w = 64
    for n, heads, batch in SMEM_SHAPES:
        body = smem_body_at(n, heads, batch)
        q, k, v = qkv_bf16(gen, batch, n, heads, w)
        plain = lambda: t(attention_ref(t(q), t(k), t(v)))
        outs = {}
        for name in ("smem", "long"):
            with launching(bodies[name]):
                outs[name] = attention_fwd(q, k, v)
        want = plain()
        torch.cuda.synchronize()
        what = f"attention_fwd {body} W={w} N={n}"
        err = check_close(what, outs["smem"], want, 2e-2, 2e-2)
        same = {"plain": bf16_ulp_diff(outs["smem"], want),
                "long": bf16_ulp_diff(outs["smem"], outs["long"])}
        for against, d in same.items():
            if d["max_diff_ulps"] > 1 or d["share_differing"] > 0.01:
                raise AssertionError(f"{what}: against the {against} version {d}")
        turns = {"smem": [], "long": []}
        for name in ("smem", "long", "long", "smem"):
            with launching(bodies[name]):
                turns[name].append(device_ms(lambda: attention_fwd(q, k, v)))
        with launching(bodies["smem"]):
            call = time_ms(lambda: attention_fwd(q, k, v))
        qh, kh, vh = (t(x).contiguous() for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
        rows.append({"shape": f"B*H={batch}*{heads} N={n} hd={w}", "dtype": "bfloat16",
                     "body": body,
                     "launcher_body": launch_plan(batch, n, heads, w, torch.bfloat16).body,
                     "max_abs_err": err, "ulps_against": same,
                     "ms": statistics.mean(turns["smem"]),
                     "long_ms": statistics.mean(turns["long"]), "turns_ms": turns,
                     "call_ms": call, "plain_ms": time_ms(plain, reps=5),
                     "library_ms": device_ms(sdpa),
                     **bound_fields(8 * batch * heads * n * w, 4 * batch * heads * n * n * w,
                                    torch.bfloat16)})
        del q, k, v, outs, want, qh, kh, vh
    return rows


# ---------------------------------------------------------------------------
# 4. serving
# ---------------------------------------------------------------------------

def seed_factors(peft, gen, scale: float = 0.5) -> None:
    """Non-zero KAdaptation factors, in place: they make the delta, its
    raw-reshape scramble and the factors' gradients live (at their zero
    init the q factors get exactly zero gradient on any path)."""
    with torch.no_grad():
        for layer in peft.layers:
            for name in ("q_left", "q_right", "v_left", "v_right"):
                p = getattr(layer, name)
                p.copy_(torch.randn(p.shape, generator=gen) * scale)
            layer.b.copy_(torch.randn(layer.b.shape, generator=gen) * 0.02)


# phase 8's seeded noise: LoRA's B factors (zero at init, which makes every
# A gradient zero too), and every per-layer leaf of the adapter and Compacter
# but Compacter's glorot factors (LayerNorms the identity and biases zero at
# init), added to their init
LORA_B_SCALE, ADAPTER_NOISE = 0.01, 0.05


def seed_baseline(peft, gen, method: str) -> None:
    """Non-zero LoRA B factors, or seeded noise on the adapter's and
    Compacter's per-layer leaves, in place, drawn from ``gen`` (a CPU
    generator)."""
    with torch.no_grad():
        for layer in peft.layers:
            for name, p in layer.named_parameters():
                if method == "lora":
                    if name in ("q_b", "v_b"):
                        p.copy_(torch.randn(p.shape, generator=gen) * LORA_B_SCALE)
                elif method == "adapter" or "_w_" not in name:
                    p.add_((torch.randn(p.shape, generator=gen) * ADAPTER_NOISE).to(p.device))


def seed_peft(peft, gen, method: str, scale: float = 0.5) -> None:
    """KAdaptation's factors at ``scale`` (``seed_factors``), or a
    baseline's seeding (``seed_baseline``)."""
    if method == "kadaptation":
        seed_factors(peft, gen, scale)
    else:
        seed_baseline(peft, gen, method)


def build_classifier(seed: int, method: str = "kadaptation", num_classes: int = 100,
                     tower: tuple = None):
    """A classifier on a seeded ViT-B/32 tower, or on ``tower`` = (clip,
    spec) where given."""
    from pevit_tpu_torch.core import CLIPSpec, init_clip_params
    from pevit_tpu_torch.data import CLIP_MEAN, CLIP_STD
    from pevit_tpu_torch.peft import PeftConfig, init_peft
    from pevit_tpu_torch.train import init_bn_state, init_head, partition, trainable_pred
    from pevit_tpu_torch.train.trainer import UNFUSED_MLP_METHODS, TaskStatic

    gen = torch.Generator().manual_seed(seed)
    clip, spec = tower or (None, CLIPSpec.vit_b32())
    cfg = PeftConfig(method=method)
    static = TaskStatic(spec=spec, peft_cfg=cfg, num_classes=num_classes,
                        use_fused_mlp=method not in UNFUSED_MLP_METHODS)
    if clip is None:
        clip = init_clip_params(gen, spec, device="cuda")
    peft = init_peft(gen, cfg, spec, device="cuda")
    seed_peft(peft, gen, method)
    head = init_head(gen, static.head_dim, static.num_classes, device="cuda")
    bn = init_bn_state(static.head_dim, device="cuda")
    bn["mean"] = (torch.randn(static.head_dim, generator=gen) * 0.1).cuda()
    bn["var"] = (torch.rand(static.head_dim, generator=gen) * 1.5 + 0.5).cuda()
    trainable, frozen = partition({"clip": clip, "peft": peft, "head": head},
                                  trainable_pred(static))
    preproc = {"mean": torch.tensor(CLIP_MEAN), "std": torch.tensor(CLIP_STD)}
    return static, trainable, frozen, bn, preproc


def fit_prototype_head(static, trainable, frozen, bn, preproc, prototypes,
                       chunk: int = 0) -> None:
    """Give the head one class per prototype image, in place: logit_c(x) =
    (z(x) - m) . d_c, where z is the BN'd feature, m the prototypes' mean z
    and d_c prototype c's unit deviation from it (a nearest-centroid head,
    as a head initialised from class embeddings is).  Its logits separate
    classes, so a top-1 comparison tests the kernels and not bf16 rounding
    between near-tied random logits.  KAdaptation's scramble makes a row's
    features depend on its batch: ``chunk`` (all at once unless given) is
    the batch the prototypes' features are taken in, that of the batch
    whose logits are then compared."""
    from pevit_tpu_torch.serve import make_serving_fn
    from pevit_tpu_torch.train import Head

    dim = static.head_dim
    probe = Head(dim, dim).cuda()
    with torch.no_grad():
        probe.linear.kernel.copy_(torch.eye(dim))  # logits = the BN'd features
    feats = make_serving_fn(dataclasses.replace(static, compute_dtype="float32"),
                            {**trainable, "head": probe}, frozen, bn, preproc, device="cuda")
    step = chunk or len(prototypes)
    z = torch.cat([feats(prototypes[i:i + step]) for i in range(0, len(prototypes), step)])
    m = z.mean(0)
    d = (z - m) / (z - m).norm(dim=-1, keepdim=True)
    head = trainable["head"]
    with torch.no_grad():
        head.linear.kernel.copy_(d.T)
        head.linear.bias.copy_(-(m @ d.T))


@contextlib.contextmanager
def plain_path():
    """Swap the blocks' kernel wrappers for their plain versions (the same
    model on the same card, every kernel replaced by plain PyTorch)."""
    from pevit_tpu_torch.core import layers
    from pevit_tpu_torch.ops.attention import attention_ref
    from pevit_tpu_torch.ops.fused_mlp import fused_mlp_residual_ref

    t = lambda x: x.transpose(1, 2)
    saved = layers.attention_core, layers.fused_mlp_residual
    layers.attention_core = lambda q, k, v: t(attention_ref(t(q), t(k), t(v)))
    layers.fused_mlp_residual = fused_mlp_residual_ref
    try:
        yield
    finally:
        layers.attention_core, layers.fused_mlp_residual = saved


def post_npy(url: str, arr: np.ndarray) -> np.ndarray:
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/infer", data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))


def serve_requests(serve, kernels, res: int, rng) -> dict:
    """Drive make_server -> MicroBatcher -> InferencePipeline with ragged
    requests from 4 client threads; returns launches and server stats."""
    from pevit_tpu_torch.serve_daemon import make_server

    srv = make_server(serve, res, device="cuda", port=0, max_batch=SERVE_BATCH)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    sizes = (1, 7, 64, 200)
    requests = [[rng.integers(0, 256, (sizes[(i + j) % 4], res, res, 3), dtype=np.uint8)
                 for j in range(4)] for i in range(4)]
    answers, errors = {}, []

    def client(i):
        try:
            answers[i] = [post_npy(url, imgs) for imgs in requests[i]]
        except Exception as e:  # reported after join, fails the run
            errors.append(e)

    for k in kernels:
        k.launches = 0
    clients = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        launches = {k.name: k.launches for k in kernels}
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.batcher.close()
        server_thread.join(timeout=30)
    if errors or any(c.is_alive() for c in clients):
        raise RuntimeError(f"client requests failed: {errors or 'timed out'}")
    for i in range(4):
        for imgs, logits in zip(requests[i], answers[i]):
            if logits.shape != (imgs.shape[0], 100) or not np.isfinite(logits).all():
                raise AssertionError(f"bad logits {logits.shape} for {imgs.shape[0]} images")
    forwards = stats["batches"]
    for name, n in launches.items():
        if n != 12 * forwards:
            raise AssertionError(f"{name}: {n} launches for {forwards} forwards, want 12 each")
    return {"launches": launches, "forwards": forwards, "stats": stats,
            "images": sum(x.shape[0] for r in requests for x in r)}


def compare_plain(serve, images, labels, dtype) -> dict:
    """Kernel path vs plain path on the same batch; ``labels`` are the
    images' prototype classes, for the printed accuracy of both paths."""
    got = serve(images)
    with plain_path():
        want = serve(images)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    acc = [(x.argmax(-1) == labels).float().mean().item() for x in (got, want)]
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the kernel path")
    if dtype == torch.float32 and err > 1e-3 * scale:
        raise AssertionError(f"fp32 logits: kernel vs plain max err {err} > 1e-3 * {scale}")
    if dtype == torch.bfloat16 and top1 < 0.99:
        raise AssertionError(f"bf16 logits: top-1 agreement {top1} < 0.99 (max err {err})")
    return {"dtype": str(dtype).split(".")[-1], "max_abs_err": err, "max_abs_logit": scale,
            "top1_agreement": top1, "accuracy_kernel": acc[0], "accuracy_plain": acc[1]}


# ---------------------------------------------------------------------------
# 5. training
# ---------------------------------------------------------------------------

TRAIN_LR, TRAIN_WD, TRAIN_EPOCHS = 1e-3, 1e-4, 2
TRAIN_FACTOR_SCALE = 0.1


def make_task(clip, dtype_name: str, dropout_p: float, method: str = "kadaptation", *,
              batch: int = TRAIN_BATCH, tpu: dict = None, spec=None):
    """A ViT-B/32 task (of ``spec`` where given) of ``method``
    (KAdaptation unless given) through the config entry points, on the
    given frozen tower, whose bundles carry seeded non-zero factors
    (``seed_peft``); ``tpu`` sets TPU knobs."""
    from pevit_tpu_torch.config import get_default_config
    from pevit_tpu_torch.core import CLIPSpec
    from pevit_tpu_torch.peft import PeftConfig
    from pevit_tpu_torch.train import TaskStatic, TrainTask

    cfg = get_default_config()
    cfg.defrost()
    cfg.DATASET.NUM_CLASSES = 100
    cfg.TRAIN.BATCH_SIZE_PER_GPU = batch
    cfg.TPU.COMPUTE_DTYPE = dtype_name
    for k, v in (tpu or {}).items():
        cfg.TPU[k] = v
    cfg.freeze()
    static = TaskStatic.from_config(cfg, spec or CLIPSpec.vit_b32(),
                                    PeftConfig(method=method, kadapt_dropout_p=dropout_p))
    task = TrainTask(cfg, static, clip, device="cuda")
    init = task.init_bundle

    def init_bundle(gen):
        trainable, frozen, bn = init(gen)
        # tamer than serving's 0.5: a sharper attention would let float32
        # rounding differences between the two paths grow over the run
        seed_peft(trainable["peft"], gen, method, scale=TRAIN_FACTOR_SCALE)
        return trainable, frozen, bn

    task.init_bundle = init_bundle
    return task


def train_data(prototypes, rng) -> tuple:
    """5 noisy copies of each of the 100 prototypes to train on, 2 more of
    each to validate on."""
    def noisy(labels):
        noise = rng.integers(-8, 9, (len(labels),) + prototypes.shape[1:], dtype=np.int16)
        return np.clip(prototypes[labels].astype(np.int16) + noise, 0, 255).astype(np.uint8)

    train_labels = np.repeat(np.arange(len(prototypes)), 5)
    val_labels = np.repeat(np.arange(len(prototypes)), 2)
    return noisy(train_labels), train_labels, noisy(val_labels), val_labels


def train_run(task, data, kernels, epochs: int = TRAIN_EPOCHS) -> dict:
    """The main training path, with launch counts read around it."""
    images, labels, val, val_labels = data
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = task.train_trials([(TRAIN_LR, TRAIN_WD)], images, labels, val, val_labels,
                            end_epoch=epochs, keep_logits=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    n_train, n_val, B = len(labels), len(val_labels), task.static.batch_size
    steps = epochs * (n_train // B + (n_train % B > 1))
    chunks = epochs * -(-n_val // task.eval_chunk)
    layers = task.static.spec.vision.layers
    want = {"attention_fwd": layers * (steps + chunks), "fused_mlp_fwd": layers * (steps + chunks),
            "fused_mlp_bwd": layers * steps}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want} for {steps} train steps and "
                             f"{chunks} eval chunks")
    loss = task.last_state.loss
    if not (torch.isfinite(loss) and np.isfinite(res[0]["best_logits"]).all()):
        raise AssertionError(f"non-finite training run: loss {loss}")
    return {"launches": launches, "train_steps": steps, "eval_chunks": chunks,
            "seconds": seconds, "last_loss": loss.item(), "best_score": res[0]["best_score"],
            "last_score": res[0]["last_score"]}


def train_throughput(task, data) -> float:
    """Train images/s over two epochs of 3 full batches, after a warm-up
    epoch, on the bundle the main run trained."""
    from pevit_tpu_torch.train import build_epoch_fn

    n = 3 * task.static.batch_size
    images = task.prepack(data[0][:n])
    labels = torch.as_tensor(data[1][:n]).cuda()
    epoch = build_epoch_fn(task.static, n, task.preproc)
    bundle, state = task.last_bundle, task.last_state
    state = epoch(bundle, images, labels, state, TRAIN_LR, TRAIN_WD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        state = epoch(bundle, images, labels, state, TRAIN_LR, TRAIN_WD)
    torch.cuda.synchronize()
    return 2 * n / (time.perf_counter() - t0)


def first_step_grads(task, images, labels) -> dict:
    """Gradients of the first step's loss for every trainable leaf, on a
    fresh bundle from a fixed seed (float32 copies)."""
    from pevit_tpu_torch.train import combine, model_forward, trainable_params
    from pevit_tpu_torch.train.trainer import _loss

    trainable, frozen, bn = task.init_bundle(torch.Generator().manual_seed(7))
    params = trainable_params(trainable)
    valid = torch.ones(len(labels), device="cuda")
    logits, _ = model_forward(task.static, combine(trainable, frozen), bn, task.prepack(images),
                              task.preproc, train=True, mask=valid,
                              forward_fn=getattr(task, "_forward_fn", None))
    loss = _loss(task.static, logits, torch.as_tensor(labels).cuda(), valid)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).float()
            for (n, p), g in zip(params.items(), grads)}


def compare_grads(task, images, labels, dtype, vanishing: tuple = (),
                  fp32_limits: dict | None = None) -> dict:
    """First-step gradients, kernel path against plain path.  ``vanishing``
    names leaves whose gradient is zero in exact arithmetic, so that what
    either path computes there is rounding noise: in fp32 each must stay
    within 1e-3 of the largest |g| of the other leaves; in bf16 their size
    is only reported.  ``fp32_limits`` gives a leaf its own fp32 limit on
    its own size in place of 1e-3."""
    got = first_step_grads(task, images, labels)
    with plain_path():
        want = first_step_grads(task, images, labels)
    torch.cuda.synchronize()
    worst, unused = {}, []
    for n, g in got.items():
        w = want[n]
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"non-finite gradient of {n}")
        if n.rsplit(".", 1)[-1] in ("v_left", "v_right"):  # quirk 1: the forward never reads them
            if g.any() or w.any():
                raise AssertionError(f"{n}: unused factor with a non-zero gradient")
            unused.append(n)
            continue
        if n in vanishing:
            continue
        if n.startswith("peft") and not g.any():
            raise AssertionError(f"{n}: zero gradient on the kernel path")
        if dtype == torch.float32:
            gap = ((g - w).abs().max() / w.abs().max()).item()
            limit = (fp32_limits or {}).get(n, 1e-3)
            if gap > limit:
                raise AssertionError(f"fp32 grad of {n}: kernel vs plain gap {gap} > {limit}")
        else:
            gap = torch.nn.functional.cosine_similarity(g.flatten(), w.flatten(), dim=0).item()
            if gap < 0.99:
                raise AssertionError(f"bf16 grad of {n}: cosine {gap} < 0.99")
        worst[n] = gap
    key = max if dtype == torch.float32 else min
    name = key(worst, key=worst.get)
    out = {"dtype": str(dtype).split(".")[-1], "leaves": len(worst),
           "zero_by_quirk_1": len(unused),
           ("max_rel_gap" if dtype == torch.float32 else "min_cosine"): worst[name], "at": name}
    if fp32_limits and dtype == torch.float32:
        out["held_to_limits"] = {n: {"gap": worst[n], "limit": limit}
                                 for n, limit in fp32_limits.items()}
    if vanishing:
        scale = max(want[n].abs().max().item() for n in worst)
        sizes = {n: max(got[n].abs().max().item(), want[n].abs().max().item()) / scale
                 for n in vanishing}
        if dtype == torch.float32 and max(sizes.values()) > 1e-3:
            raise AssertionError(f"fp32 grads that vanish in exact arithmetic: {sizes} of the "
                                 "largest |g|, want <= 1e-3")
        out["vanishing_rel_size"] = sizes
    return out


@contextlib.contextmanager
def rounded_f64_attention():
    """The plain path, with the blocks' attention computed in float64
    (forward and backward) and rounded to float32: as sound a float32
    attention as there is, the witness of what rounding alone moves."""
    from pevit_tpu_torch.core import layers

    with plain_path():
        layers.attention_core = lambda q, k, v: attention_f64(q, k, v).to(q.dtype)
        yield


def witness_gaps(task, images, labels, names) -> dict:
    """Each leaf of ``names``: the gap of its fp32 first-step gradient under
    :func:`rounded_f64_attention` to the plain path's, on its own size (max
    |g - g_plain| / max |g_plain|)."""
    with plain_path():
        want = first_step_grads(task, images, labels)
    with rounded_f64_attention():
        got = first_step_grads(task, images, labels)
    return {n: ((got[n] - want[n]).abs().max() / want[n].abs().max()).item() for n in names}


def compare_whole_run(task, data) -> dict:
    """Two fp32 epochs from one seeded bundle, in one order, kernel path
    against plain path; per-epoch val logits."""
    from pevit_tpu_torch.train import (TrainState, build_fit_eval_fn, combine, make_optimizer,
                                       trainable_params)

    images, labels, val, val_labels = data
    st = task.static
    fit_eval = build_fit_eval_fn(st, len(labels), TRAIN_EPOCHS, task.preproc,
                                 eval_chunk=task.eval_chunk, n_val=len(val_labels))
    orders = [np.random.default_rng(e).permutation(len(labels)) for e in range(TRAIN_EPOCHS)]
    opt_init, _ = make_optimizer(st.optimizer, momentum=st.momentum, nesterov=st.nesterov)
    x, y, xv = task.prepack(images), torch.as_tensor(labels).cuda(), task.prepack(val)

    def run():
        trainable, frozen, bn = task.init_bundle(torch.Generator().manual_seed(11))
        params = trainable_params(trainable)
        state = TrainState(params, opt_init(params), bn, torch.Generator().manual_seed(12))
        return fit_eval(combine(trainable, frozen), x, y, xv, state,
                        [TRAIN_LR] * TRAIN_EPOCHS, TRAIN_WD, orders)[1]

    got = run()
    with plain_path():
        want = run()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite val logits on the kernel path")
    gaps = [(got[e] - want[e]).abs().max().item() for e in range(TRAIN_EPOCHS)]
    scale = want.abs().max().item()
    if max(gaps) > 1e-3 * scale:
        raise AssertionError(f"fp32 whole run: val logit gaps {gaps} > 1e-3 * {scale}")
    moved = (want[-1] - want[0]).abs().max().item()  # what training changed meanwhile
    return {"dtype": "float32", "epoch_max_abs_gaps": gaps, "max_abs_logit": scale,
            "max_abs_change_first_to_last_epoch": moved}


# ---------------------------------------------------------------------------
# 6. the command
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent
ARTIFACT_KEYS = ["model_name", "dataset_name", "num_trainable_params", "num_params",
                 "num_visual_params", "num_backbone_params", "n_shot", "rnd_seeds", "predictions"]
TXT_LINE = re.compile(r"best acc is:([0-9.eE+-]+), num_params is:(\S+?), "
                      r"n_trainable_params is:([0-9.eE+-]+), backbone_params is:(\S+?)\.")


def command_argv(tmp: Path, no_tuning: str = "False", lr: str = "0.0", l2: str = "0.0") -> list:
    """scripts/kadapter_clip.sh's flags for cifar-10, seed 0, with random
    weights and the synthetic split in ``tmp`` (the other PEFT scripts
    differ only in the command); ``no_tuning``, ``lr`` and ``l2`` are the
    script's configuration section."""
    return ["--ds", str(REPO / "resources/datasets/cifar10.yaml"),
            "--model", str(REPO / "resources/model/vitb32_CLIP.yaml"),
            "--no-tuning", no_tuning, "--lr", lr, "--l2", l2,
            "DATASET.NUM_SAMPLES_PER_CLASS", "5", "DATASET.RANDOM_SEED_SAMPLING", "0",
            "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER", "True", "MODEL.PRETRAINED", "random",
            "DATASET.ALLOW_SYNTHETIC", "True", "DATASET.ROOT", str(tmp / "data"),
            "OUTPUT_DIR", str(tmp / "out")]


def reference_walk(score, config) -> tuple:
    """The reference's sequential (lr, wd) selection (kadaptation_clip.py:
    188-243, 446-466), replayed over ``score(lr, wd)``."""
    grid = np.logspace(config.TRAIN.SEARCH_WD_LOG_LOWER, config.TRAIN.SEARCH_WD_LOG_UPPER,
                       97).tolist()
    seeds = set(np.logspace(config.TRAIN.SEARCH_WD_LOG_LOWER, config.TRAIN.SEARCH_WD_LOG_UPPER, 7))
    init_idx = [i for i, v in enumerate(grid) if v in seeds]
    best_lr, best_wd, best = 0.0, 0.0, 0.0
    for lr in np.logspace(-6, -1, 6).tolist():
        peak_idx, peak = -1, 0.0
        for idx in init_idx:
            if score(lr, grid[idx]) > peak:
                peak_idx, peak = idx, score(lr, grid[idx])
        span = 8
        while span > 0:
            left, right = max(peak_idx - span, 0), min(peak_idx + span, len(grid) - 1)
            for idx in (i for i in (left, right) if i != peak_idx):
                s = score(lr, grid[left] if config.TRAIN.WD_SEARCH_LEFT else grid[idx])
                if s > peak:
                    peak_idx, peak = idx, s
            span //= 2
        if peak > best:
            best, best_lr, best_wd = peak, lr, grid[peak_idx]
    return best_lr, best_wd


def trial_call(task, hparams, train_labels, val_labels, end_epoch: int,
               begin_epoch: int = 0) -> dict:
    """What one ``train_trials`` call gives the kernels: its chunk of
    trials, run as one batch, and its split sizes, epochs, batch and eval
    chunk."""
    return {"trials": len(hparams), "n_train": len(train_labels), "n_val": len(val_labels),
            "epochs": end_epoch - begin_epoch, "batch": task.static.batch_size,
            "chunk": task.eval_chunk, "emulated": task.static.emulate_zero_shot}


@contextlib.contextmanager
def recorded_calls(calls: list):
    """Record every ``TrainTask.train_trials`` call made inside the block
    (``trial_call``), in order."""
    from pevit_tpu_torch.train import TrainTask

    real = TrainTask.train_trials

    def record(self, hparams, tx, ty, vx, vy, *, end_epoch, begin_epoch=0, **kw):
        calls.append(trial_call(self, hparams, ty, vy, end_epoch, begin_epoch))
        return real(self, hparams, tx, ty, vx, vy, end_epoch=end_epoch,
                    begin_epoch=begin_epoch, **kw)

    TrainTask.train_trials = record
    try:
        yield calls
    finally:
        TrainTask.train_trials = real


@contextlib.contextmanager
def timed_command(times: dict):
    """Time a command's text features, image features, sweep and
    ``run_method`` by wrapping them where the commands look them up; keeps
    the arguments and results of all but the sweep, and every
    ``train_trials`` call in ``times["calls"]``."""
    import pevit_tpu_torch.evaluation as evaluation
    import pevit_tpu_torch.train as train
    from pevit_tpu_torch.train import sweep

    wrapped = [(evaluation, "extract_text_features", "text_features", True),
               (evaluation, "extract_image_features", "image_features", True),
               (sweep, "hyperparameter_sweep_lr", "sweep", False),
               (train, "run_method", "run_method", True)]
    saved = [getattr(module, attr) for module, attr, _, _ in wrapped]

    def wrap(name, fn, keep):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            if keep:
                times[name + "_call"] = (args, out)
            return out
        return timed

    for (module, attr, name, keep), fn in zip(wrapped, saved):
        setattr(module, attr, wrap(name, fn, keep))
    try:
        with recorded_calls(times.setdefault("calls", [])):
            yield
    finally:
        for (module, attr, _, _), fn in zip(wrapped, saved):
            setattr(module, attr, fn)


def check_text_features_on_cpu(call) -> dict:
    """The card's text features against the same tower's run on the CPU."""
    from pevit_tpu_torch.evaluation import extract_text_features

    (config, clip, spec), card = call
    cpu_clip = copy.deepcopy(clip).cpu()
    cpu = extract_text_features(config, cpu_clip, spec)
    err = float(np.abs(card - cpu).max())
    scale = float(np.abs(cpu).max())
    if card.shape != cpu.shape or not err <= 1e-4 * scale:
        raise AssertionError(f"text features card vs CPU: max err {err} > 1e-4 * {scale}")
    return {"shape": list(card.shape), "max_abs_err": err, "max_abs": scale}


def call_batches(calls: list) -> tuple:
    """Images in each kernel launch of a path's train steps and eval chunks,
    as two ``{images: times run}`` counts, from its ``train_trials`` calls
    (``trial_call``): every call trains its epochs on its train split and
    evaluates its val split after each, full batches plus a natural tail
    (one of a single image skipped), eval chunks of the task's chunk plus a
    natural remainder.  A chunk of T trials runs each step and each eval
    chunk once, at T times the images.  An emulated zero-shot run takes no
    train step."""
    def add(counts, n, size, times, tail_min, width):
        counts[width * size] += times * (n // size)
        if n % size >= tail_min:
            counts[width * (n % size)] += times

    train, evals = collections.Counter(), collections.Counter()
    for c in calls:
        if not c["emulated"]:
            add(train, c["n_train"], c["batch"], c["epochs"], 2, c["trials"])
        add(evals, c["n_val"], c["chunk"], c["epochs"], 1, c["trials"])
    return +train, +evals


def path_batches(task, calls: list) -> dict:
    """What one run of a training command gave the kernels: its batches
    (``call_batches`` of its ``train_trials`` calls), dtype and widths, and
    which kernels it routes through: K2 wherever the fused MLP is on (all
    but full_finetune, the adapter and Compacter), K3 where a gradient also
    flows through it (all but the linear probe, which trains the head
    only)."""
    st = task.static
    vision = st.spec.vision
    train, evals = call_batches(calls)
    return {"dtype": st.compute_dtype, "train": train, "evals": evals, "layers": vision.layers,
            "width": vision.width, "tokens": vision.seq_len, "fused_mlp": st.use_fused_mlp,
            "fused_mlp_bwd": st.use_fused_mlp and st.peft_cfg.method != "linear_probe"}


def expected_launches(batches: dict) -> dict:
    """K1 runs once a block in every train step and eval chunk, K2 too where
    the path takes the fused MLP, K3 once a block in every train step where
    a gradient flows through it."""
    steps, chunks = sum(batches["train"].values()), sum(batches["evals"].values())
    layers = batches["layers"]
    return {"attention_fwd": layers * (steps + chunks),
            "fused_mlp_fwd": layers * (steps + chunks) if batches["fused_mlp"] else 0,
            "fused_mlp_bwd": layers * steps if batches["fused_mlp_bwd"] else 0}


def path_kernel_rows(gen, path: str, batches: dict) -> dict:
    """Every kernel of a path against its plain version at each batch the
    path gave it (train steps and eval chunks), in the path's dtype, with the
    launches the path made at that batch."""
    train, evals, layers = batches["train"], batches["evals"], batches["layers"]
    dtype, tokens, width = getattr(torch, batches["dtype"]), batches["tokens"], batches["width"]
    rows = {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}
    heads = batches.get("heads", 12)  # a model rank's heads under tensor parallelism
    hd = batches.get("head_dim", 64)
    for b in sorted(set(train) | set(evals)):
        n = {"path": path, "images": b, "launches": layers * (train[b] + evals[b])}
        rows["attention_fwd"].append({**check_attention(gen, dtype, tokens, b, heads, hd), **n})
        if batches["fused_mlp"]:
            rows["fused_mlp_fwd"].append({**check_fused_mlp(gen, dtype, width, b * tokens), **n})
    if batches["fused_mlp_bwd"]:
        for b in sorted(train):
            n = {"path": path, "images": b, "launches": layers * train[b]}
            rows["fused_mlp_bwd"].append({**check_fused_mlp_bwd(gen, dtype, width, b * tokens),
                                          **n})
    return rows


def kernel_report(kernels, launches: dict, table: dict, body_rows: dict = None) -> list:
    """The ``kernels`` line: launches summed over the paths of phases 6 to 17
    (each read around its own run) and by body (each path's rows name the
    body its launches ran); the other numbers at the batch that launched the
    kernel most (the larger batch on a tie); every path's batches under
    ``by_shape``; under ``bodies`` each body with its launches and the
    numbers of its row that launched most, or, for a body no path ran, of
    its first row in ``body_rows`` ({kernel: rows}, phase 3c's)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_peak", "library_ms")
    report = []
    for k in kernels:
        rows_ = table[k.name]
        total = sum(path[k.name] for path in launches.values())
        main_row = max(rows_, key=lambda r: (r["launches"], r["images"]))
        if sum(r["launches"] for r in rows_) != total:
            raise AssertionError(f"{k.name}: the paths' batches do not add up to its launches")
        by_body = collections.Counter()
        for r in rows_:
            by_body[r["body"]] += r["launches"]
        bodies = {}
        for r in sorted(rows_, key=lambda r: (r["launches"], r["images"]), reverse=True):
            bodies.setdefault(r["body"], {"body": r["body"], "launches": by_body[r["body"]],
                                          "shape": r["shape"], **{key: r[key] for key in keys}})
        for r in (body_rows or {}).get(k.name, []):
            bodies.setdefault(r["body"], {"body": r["body"], "launches": 0, "row": "3c",
                                          "shape": r["shape"], **{key: r[key] for key in keys}})
        report.append({"name": k.name, "route": "cuda",
                       "source": str(k.source.relative_to(REPO)),
                       "replaces": k.replaces, "launches": total,
                       "launches_by_path": {p: n[k.name] for p, n in launches.items()},
                       "launches_by_body": dict(by_body), "bodies": list(bodies.values()),
                       **{key: main_row[key] for key in keys}, "shape": main_row["shape"],
                       "dtype": main_row["dtype"],
                       "by_shape": [{key: r[key] for key in ("path", "images", "dtype", "body",
                                                              "shape", "launches") + keys}
                                    for r in rows_]})
    return report


def reset_launches(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read_launches(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def check_command_artifacts(tmp: Path) -> None:
    """The PEFT commands' JSON and TXT artifacts in ``tmp/out``: the
    reference's schema, predictions (160, 10) with rows summing to 1."""
    folder = tmp / "out" / "predictions" / "finetuning_5"
    artifact = json.loads((folder / "seed0_cifar-10.json").read_text())
    line = TXT_LINE.search((folder / "seed0_cifar-10.txt").read_text())
    if list(artifact) != ARTIFACT_KEYS or line is None:
        raise AssertionError(f"artifacts off the reference schema: {list(artifact)}, {line}")
    preds = np.asarray(artifact["predictions"][0])
    if preds.shape != (160, 10) or not np.allclose(preds.sum(-1), 1.0, atol=1e-4):
        raise AssertionError(f"predictions {preds.shape}, row sums {preds.sum(-1)[:4]}")


def check_sweep(cache: Path, info: dict) -> list:
    """A sweep's cache file: 42 to 90 distinct trials, and the (lr, wd) the
    command chose is the reference walk's over their scores.  Returns the
    file's records."""
    from pevit_tpu_torch.config import get_default_config

    records = [json.loads(x) for x in cache.read_text().splitlines()]
    scores = {(r["lr"], r["wd"]): r["score"] for r in records}
    if not 42 <= len(scores) <= 90:
        raise AssertionError(f"{len(scores)} distinct sweep trials, want 42 to 90")
    want = reference_walk(lambda lr, wd: scores[(repr(lr), repr(wd))], get_default_config())
    if (info["best_lr"], info["best_l2_lambda"]) != want:
        raise AssertionError(f"sweep chose {info['best_lr']}, {info['best_l2_lambda']}; "
                             f"the reference walk over its scores chooses {want}")
    return records


def run_command(kernels, tmp: Path) -> dict:
    """Phase 6: the KAdaptation command end to end, then once more to
    replay; its outputs stay in ``tmp`` for phase 8."""
    from pevit_tpu_torch.commands import kronecker_adaptation_clip

    from pevit_tpu_torch.ckpt import restore_trainable
    from pevit_tpu_torch.train import trainable_params

    t_phase = time.perf_counter()
    argv = command_argv(tmp) + ["TPU.CHECKPOINT_DIR", str(tmp / "ckpt")]
    times = {}
    reset_launches(kernels)
    t0 = time.perf_counter()
    with timed_command(times):
        best, info = kronecker_adaptation_clip.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels)

    check_command_artifacts(tmp)
    (cache,) = (tmp / "out" / "cifar-10" / "sweep_cache").iterdir()
    records = check_sweep(cache, info)
    scores = {(r["lr"], r["wd"]) for r in records}

    (task, data, config), _ = times["run_method_call"]
    trials = len(records)  # each trained once, replays aside
    chunks = [c["trials"] for c in times["calls"][:-1]]  # the sweep's, then the final run
    if sum(chunks) != trials or max(chunks) > task.max_parallel_trials():
        raise AssertionError(f"sweep chunks {chunks} for {trials} trials")
    batches = path_batches(task, times["calls"])
    want_launches = expected_launches(batches)
    if launches != want_launches:
        raise AssertionError(f"command launches {launches}, want {want_launches} for "
                             f"{trials} trials in chunks {chunks} and the final run")

    # TPU.CHECKPOINT_DIR: the final run's trained state, restored bit for bit
    epochs = config.TRAIN.END_EPOCH + config.TRAIN.EXTRA_FINAL_TRAIN_EPOCH
    saved = sorted(f.name for f in (tmp / "ckpt").iterdir())
    restored = restore_trainable(str(tmp / "ckpt"), task.last_bundle)
    trained = trainable_params(task.last_trainable)
    if saved != [f"step_{epochs}.npz"] or restored.keys() != trained.keys() or not all(
            torch.equal(restored[n], trained[n]) for n in trained):
        raise AssertionError(f"TPU.CHECKPOINT_DIR holds {saved}; restored state differs "
                             "from the final run's")

    text = check_text_features_on_cpu(times["text_features_call"])

    reset_launches(kernels)
    t1 = time.perf_counter()
    best2, info2 = kronecker_adaptation_clip.main(argv)
    replay_s = time.perf_counter() - t1
    replay_launches = read_launches(kernels)
    if best2 != best or any(replay_launches.values()) or replay_s > 60:
        raise AssertionError(f"replay: best {best2} vs {best}, launches {replay_launches}, "
                             f"{replay_s:.1f} s")
    close_command_logs()
    final_s = times["run_method"] - times["sweep"]
    final_images = (len(data[1]) + len(data[3])) * epochs
    return {"best_acc": best, "best_lr": info["best_lr"], "best_wd": info["best_l2_lambda"],
            "n_params": info["n_params"], "n_trainable_params": info["n_trainable_params"],
            "trials": trials, "distinct_trials": len(scores), "sweep_chunks": chunks,
            "launches": launches,
            "train_step_images": dict(batches["train"]),
            "eval_chunk_images": dict(batches["evals"]), "text_features": text,
            "checkpoint": {"file": saved[0], "leaves": len(trained), "restored": "bit-equal"},
            "batches": batches, "seconds": {
                "command": seconds, "text_features": times["text_features"],
                "sweep": times["sweep"], "sweep_per_trial": times["sweep"] / trials,
                "final_run": final_s, "replay": replay_s,
                "phase": time.perf_counter() - t_phase},
            "final_train_images_per_s": final_images / final_s}


def close_command_logs() -> None:
    """Close the log handlers a command opened (they write into its output
    directory, which is about to go)."""
    root = logging.getLogger()
    for h in root.handlers[:]:
        h.close()
        root.removeHandler(h)


# ---------------------------------------------------------------------------
# 7. the other entry points
# ---------------------------------------------------------------------------

CKPT_SEED = 1
ZEROSHOT_CHUNK = 256  # extract_image_features' chunk, the tail zero-padded to it
# cut for the time limit: the finetune command trains 2 + 1 epochs, not 10 + 40
FINETUNE_EPOCHS = ["TRAIN.END_EPOCH", "2", "TRAIN.EXTRA_FINAL_TRAIN_EPOCH", "1"]
NATIVE_BATCH = (64, 375, 500, 3)  # non-square photos, resized to 224


def write_checkpoints(tmp: Path) -> tuple:
    """The seeded ViT-B/32 CLIP (both towers, on the CPU) and two OpenAI-layout
    checkpoints of it: a ``torch.save`` pickle of the state dict, and the
    same inside ``{"state_dict": ...}``."""
    from pevit_tpu_torch.ckpt import clip_to_state_dict
    from pevit_tpu_torch.core import CLIPSpec, init_clip_params

    src = init_clip_params(torch.Generator().manual_seed(CKPT_SEED), CLIPSpec.vit_b32(),
                           device="cpu")
    sd = clip_to_state_dict(src)
    paths = {"pickle": tmp / "ViT-B-32.pt", "state_dict": tmp / "ViT-B-32_wrapped.pt"}
    torch.save(sd, paths["pickle"])
    torch.save({"state_dict": sd, "epoch": 0}, paths["state_dict"])
    return src, paths


def same_tensors(module, src, what: str) -> None:
    """Every tensor of ``module`` equals ``src``'s bit for bit."""
    got, want = module.state_dict(), src.state_dict()
    bad = [k for k, t in want.items() if k not in got or not torch.equal(got[k].cpu(), t)]
    if bad or got.keys() != want.keys():
        raise AssertionError(f"{what}: {len(bad)} of {len(want)} tensors differ from the "
                             f"checkpoint's, e.g. {bad[:3]}")


def check_checkpoint_loads(src, paths: dict) -> dict:
    """``load_clip`` onto the card from each checkpoint: bit-exact, timed."""
    from pevit_tpu_torch.ckpt import load_clip
    from pevit_tpu_torch.core import CLIPSpec

    out = {}
    for layout, path in paths.items():
        t0 = time.perf_counter()
        clip, spec = load_clip("ViT-B/32", checkpoint_path=str(path), device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if spec != CLIPSpec.vit_b32() or clip.visual.proj.device.type != "cuda":
            raise AssertionError(f"{layout}: loaded {spec} on {clip.visual.proj.device}")
        same_tensors(clip, src, f"load_clip from a {layout} checkpoint")
        out[layout] = {"load_s": seconds, "file_bytes": path.stat().st_size,
                       "tensors": len(src.state_dict())}
        del clip
    return out


def entry_argv(tmp: Path, ckpt: Path, *options) -> list:
    """A command's arguments on synthetic cifar-10 with the published
    ViT-B/32 model file and the checkpoint; outputs in ``tmp``."""
    return ["--ds", str(REPO / "resources/datasets/cifar10.yaml"),
            "--model", str(REPO / "resources/model/vitb32_CLIP.yaml"), *options,
            "MODEL.PRETRAINED", str(ckpt), "DATASET.ALLOW_SYNTHETIC", "True",
            "DATASET.ROOT", str(tmp / "data"), "OUTPUT_DIR", str(tmp / "out")]


def check_predictions(path: Path, n: int, classes: int = 10) -> None:
    artifact = json.loads(path.read_text())
    preds = np.asarray(artifact["predictions"][0])
    if list(artifact) != ARTIFACT_KEYS or preds.shape != (n, classes) or not np.allclose(
            preds.sum(-1), 1.0, atol=1e-4):
        raise AssertionError(f"{path.name}: keys {list(artifact)}, predictions {preds.shape}")


def run_zeroshot(kernels, tmp: Path, ckpt: Path) -> dict:
    """The zero-shot command: float32 image features through K1's and K2's
    fp32 bodies in chunks of 256, held to the plain path on the card; then a
    replay from the feature cache, which launches nothing."""
    from pevit_tpu_torch.commands import zeroshot
    from pevit_tpu_torch.evaluation import extract_image_features

    argv = entry_argv(tmp, ckpt)
    times = {}
    reset_launches(kernels)
    t0 = time.perf_counter()
    with timed_command(times):
        result = zeroshot.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels)
    (config, clip, spec, images), _ = times["image_features_call"]
    # the features as the command cached them (its evaluator normalises the
    # returned array in place, as the reference's does)
    feats = np.load(zeroshot.feature_paths(config)[0])
    n = len(images)
    batches = {"dtype": "float32", "train": collections.Counter(),
               "evals": collections.Counter({ZEROSHOT_CHUNK: -(-n // ZEROSHOT_CHUNK)}),
               "layers": spec.vision.layers, "width": spec.vision.width,
               "tokens": spec.vision.seq_len, "fused_mlp": True, "fused_mlp_bwd": False}
    if launches != expected_launches(batches):
        raise AssertionError(f"zero-shot launches {launches}, want {expected_launches(batches)}")
    check_predictions(tmp / "out" / "predictions" / zeroshot_exp_name(config) / "seed0_cifar-10.json",
                      n)

    with plain_path():
        plain = extract_image_features(config, clip, spec, images)
    err, scale = float(np.abs(feats - plain).max()), float(np.abs(plain).max())
    if feats.shape != plain.shape or not err <= 1e-4 * scale:
        raise AssertionError(f"zero-shot image features kernel vs plain path: {err} > 1e-4 * {scale}")
    t1 = time.perf_counter()
    extract_image_features(config, clip, spec, images)
    warm_s = time.perf_counter() - t1

    reset_launches(kernels)
    replay = zeroshot.main(argv)
    replay_launches = read_launches(kernels)
    if replay != result or any(replay_launches.values()):
        raise AssertionError(f"zero-shot replay: {replay} vs {result}, launches {replay_launches}")
    close_command_logs()
    return {"result": result, "images": n, "launches": launches,
            "features": {"max_abs_err_vs_plain": err, "max_abs": scale},
            "seconds": {"command": seconds, "image_features": times["image_features"],
                        "text_features": times["text_features"]},
            "feature_images_per_s": n / times["image_features"],
            "feature_images_per_s_warm": n / warm_s, "batches": batches}


def zeroshot_exp_name(config) -> str:
    k = config.KNOWLEDGE
    return (f"zeroshot_eval_wiki_{k.WIKITIONARY.USE_DEFINITION}_wnh_{k.WORDNET.USE_HIERARCHY}"
            f"_wnd_{k.WORDNET.USE_DEFINITION}_gpt3_{k.GPT3.USE_GPT3}")


def run_training_entry(kernels, module, tmp: Path, ckpt: Path, folder: str, *options) -> tuple:
    """One run of a training command with ``--no-tuning True``: exact
    launches for its steps and eval chunks, and the predictions artifact.
    Returns (summary, task, data, batches)."""
    argv = entry_argv(tmp, ckpt, "--no-tuning", "True", *options)
    times = {}
    reset_launches(kernels)
    t0 = time.perf_counter()
    with timed_command(times):
        best, info = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels)
    (task, data, config), _ = times["run_method_call"]
    batches = path_batches(task, times["calls"])
    if launches != expected_launches(batches):
        raise AssertionError(f"{folder}: launches {launches}, want {expected_launches(batches)}")
    n_test = len(data[5])
    check_predictions(tmp / "out" / "predictions" / folder / "seed0_cifar-10.json", n_test)
    epochs = config.TRAIN.END_EPOCH + config.TRAIN.EXTRA_FINAL_TRAIN_EPOCH
    steps = sum(batches["train"].values())
    summary = {"best_acc": best, "n_trainable_params": info["n_trainable_params"],
               "n_params": info["n_params"], "epochs": epochs, "train_steps": steps,
               "launches": launches, "train_step_images": dict(batches["train"]),
               "eval_chunk_images": dict(batches["evals"]),
               "seconds": {"command": seconds, "run_method": times["run_method"]}}
    if steps:
        images = (len(data[1]) + len(data[3])) * epochs
        summary["train_images_per_s"] = images / times["run_method"]
    return summary, task, data, batches


def run_linear_probe(kernels, tmp: Path, ckpt: Path) -> tuple:
    """The linear probe, trained (``--no-tuning True``) and as an emulated
    zero-shot run (``--emulate-zeroshot True``), which takes no train step:
    K1 and K2 launch for every step and eval chunk, K3 never."""
    from pevit_tpu_torch.commands import linear_probe

    out, paths = {}, {}
    for name, folder, options in (("linear_probe", "linear_probe_5",
                                   ("DATASET.NUM_SAMPLES_PER_CLASS", "5")),
                                  ("emulated_zero_shot", "linear_probe_full",
                                   ("--emulate-zeroshot", "True"))):
        summary, task, _, batches = run_training_entry(kernels, linear_probe, tmp / name, ckpt,
                                                       folder, *options)
        if name == "emulated_zero_shot" and (task.last_state.loss is not None
                                             or summary["train_steps"]):
            raise AssertionError("the emulated zero-shot run took a train step")
        out[name], paths[name] = summary, batches
        close_command_logs()
    return out, paths


def run_finetune(kernels, tmp: Path, ckpt: Path, src) -> tuple:
    """Full fine-tuning (``--no-tuning True``, 3 epochs): K1 launches for
    every step and eval chunk, K2 and K3 never; first-step gradients of the
    visual tower, kernel vs plain path, in bf16 and fp32; the text tower and
    the pretrained tower unchanged after the run; the trainable count the
    visual tower plus the head."""
    from pevit_tpu_torch.commands import finetune

    summary, task, data, batches = run_training_entry(
        kernels, finetune, tmp, ckpt, "finetuning_5", "--lr", "1e-5", "--l2", "0.0001",
        "DATASET.NUM_SAMPLES_PER_CLASS", "5", *FINETUNE_EPOCHS)
    same_tensors(task.clip, src, "the pretrained tower after the finetune run")
    trained = task.last_bundle["clip"]
    if trained.text is not task.clip.text or torch.equal(trained.visual.proj, task.clip.visual.proj):
        raise AssertionError("the finetune run trained no copy of the visual tower")
    st = task.static
    want_n = (sum(p.numel() for p in task.clip.visual.parameters())
              + st.head_dim * st.num_classes + st.num_classes)
    if summary["n_trainable_params"] != want_n:
        raise AssertionError(f"n_trainable_params {summary['n_trainable_params']}, want {want_n}")
    images, labels = data[0][:TRAIN_BATCH], data[1][:TRAIN_BATCH]
    summary["first_step_grads"] = []
    # the train-mode BN of the head subtracts the batch mean of the features,
    # which cancels ln_post's bias: it shifts every feature by one vector
    vanishing = ("clip.visual.ln_post.bias",) if st.use_bn else ()
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        variant = copy.copy(task)
        variant.static = dataclasses.replace(st, compute_dtype=dtype_name)
        summary["first_step_grads"].append(compare_grads(variant, images, labels, dtype,
                                                         vanishing))
    close_command_logs()
    return summary, batches


def native_resize(rng) -> dict:
    """The C++ resampler built with g++ on the card's host; a seeded batch of
    non-square images resized to 224, batched and one at a time."""
    from pevit_tpu_torch import native
    from pevit_tpu_torch.data.transforms import resize_center_crop

    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    imgs = rng.integers(0, 256, NATIVE_BATCH, dtype=np.uint8)
    native.native_resize_center_crop_batch(imgs[:2], 224)  # load the library
    t0 = time.perf_counter()
    out = native.native_resize_center_crop_batch(imgs, 224)
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = np.stack([resize_center_crop(im.transpose(1, 0, 2), 224) for im in imgs])
    single_s = time.perf_counter() - t0
    if out.shape != (len(imgs), 224, 224, 3) or one.shape != out.shape:
        raise AssertionError(f"native resize shapes {out.shape}, {one.shape}")
    if not np.array_equal(out[3], native.native_resize_center_crop(imgs[3], 224)):
        raise AssertionError("native resize: the batch and the one-image call differ")
    return {"build_s": build_s, "images": len(imgs), "landscape": list(NATIVE_BATCH[1:3]),
            "images_per_s_batch": len(imgs) / batch_s,
            "images_per_s_one_at_a_time_portrait": len(imgs) / single_s}


def run_entry_points(kernels, gen, card: str) -> tuple:
    """Phase 7; returns the launches and kernel rows of its paths."""
    launches, table = {}, {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}

    def rows(path, batches):
        for name, rows_ in path_kernel_rows(gen, path, batches).items():
            table[name].extend(rows_)
            for r in rows_:
                print(f"{path} kernel {name} {json.dumps(r)} [{card}]", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        src, paths = write_checkpoints(tmp)
        write_s = time.perf_counter() - t0
        loads = check_checkpoint_loads(src, paths)
        print(f"checkpoint: written in {write_s:.2f} s; {json.dumps(loads)} [{card}]", flush=True)
        ckpt = paths["pickle"]

        zs = run_zeroshot(kernels, tmp / "zeroshot", ckpt)
        batches = zs.pop("batches")
        launches["zeroshot"] = zs["launches"]
        print(f"command zeroshot: {json.dumps(zs)} [{card}]", flush=True)
        rows("zeroshot", batches)

        probes, probe_batches = run_linear_probe(kernels, tmp, ckpt)
        for name, summary in probes.items():
            launches[name] = summary["launches"]
            print(f"command {name}: {json.dumps(summary)} [{card}]", flush=True)
            rows(name, probe_batches[name])

        ft, batches = run_finetune(kernels, tmp / "finetune", ckpt, src)
        launches["finetune"] = ft["launches"]
        print(f"command finetune: {json.dumps(ft)} [{card}]", flush=True)
        rows("finetune", batches)
    return launches, table


# ---------------------------------------------------------------------------
# 8. the baselines
# ---------------------------------------------------------------------------

BASELINES = ("lora", "adapter", "compacter")
# each method's trainable PEFT count at ViT-B/32 as the JAX package gives it
# (pevit_tpu.peft.base.peft_num_params; Compacter's 64-element shared rule is
# frozen), which tests/test_torch_peft_methods.py holds the port to
JAX_PEFT_TRAINABLE = {"lora": 147_456, "adapter": 1_208_064, "compacter": 48_448 - 64}
# the adapter's and Compacter's commands run the final run only (no sweep,
# for the time limit), at a learning rate and weight decay of the sweep's grid
BASELINE_FINAL = {"no_tuning": "True", "lr": "0.001", "l2": "0.0001"}


def path_launch_want(static) -> dict:
    """K1 / K2 / K3 launches of one train step and of one eval chunk or
    forward of a task's tower, one of each a block: K2 and K3 only where the
    blocks take the fused MLP (of the baselines, LoRA), K3 only in a train
    step."""
    layers = static.spec.vision.layers
    fused = layers if static.use_fused_mlp else 0
    return {"step": {"attention_fwd": layers, "fused_mlp_fwd": fused, "fused_mlp_bwd": fused},
            "forward": {"attention_fwd": layers, "fused_mlp_fwd": fused, "fused_mlp_bwd": 0}}


def check_launches(kernels, what: str, want: dict, fn):
    """Run ``fn`` with the counts zeroed and hold its launches to ``want``."""
    reset_launches(kernels)
    out = fn()
    torch.cuda.synchronize()
    got = read_launches(kernels)
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return out


def worst_cosine(task, images, labels) -> dict:
    """The leaf whose first-step gradient is least aligned between the
    kernel path and the plain path, and its cosine (reported, not held)."""
    got = first_step_grads(task, images, labels)
    with plain_path():
        want = first_step_grads(task, images, labels)
    cos = {n: torch.nn.functional.cosine_similarity(g.flatten(), want[n].flatten(), dim=0).item()
           for n, g in got.items()}
    at = min(cos, key=cos.get)
    return {"min_cosine": cos[at], "at": at}


def baseline_checks(kernels, method: str, clip, images, labels, serve_images) -> dict:
    """One baseline on the frozen ViT-B/32 tower: the launches of a train
    step and of a forward; first-step gradients, kernel vs plain path, bf16
    and fp32; a bf16 serving forward of ``serve_images`` against the plain
    path, its head fitted to those images' fp32 features, one class each.

    The bf16 gradients are held with the head's BatchNorm off (and reported
    with it on).  In train mode it divides each feature by its spread over
    the batch, which for random images through a random tower is small
    beside the feature itself, so a one-ulp difference in any block's
    attention output (the kernel and its plain version sum in different
    orders) moves the adapters' smaller gradients by up to a few percent,
    on either path alike: the adapter's worst cosine with it on was 0.98994
    on an H100 (80GB HBM3, 700 W) while every fp32 leaf agreed within 1e-3.
    The fp32 gradients are held with it on.

    The head is fitted to the served batch itself because LoRA's raw-reshape
    scramble makes a row's features depend on the rows around it: a head
    fitted to 100 prototypes in a batch of 100, as phase 4's, does not fit
    them in a batch of 256, and the top-1 comparison would test near-ties
    (agreement 0.988 for LoRA on the same H100), not the kernels."""
    from pevit_tpu_torch.serve import make_serving_fn
    from pevit_tpu_torch.train import trainable_params

    out = {"first_step_grads": []}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        task = make_task(clip, dtype_name, 0.0, method)
        if task.static.use_fused_mlp is not (method == "lora"):
            raise AssertionError(f"{method}: use_fused_mlp {task.static.use_fused_mlp}")
        want = path_launch_want(task.static)
        trainable, frozen, _ = task.init_bundle(torch.Generator().manual_seed(7))
        names = set(trainable_params(trainable))
        if method == "compacter" and ("peft.shared.phm_rule" in names
                                      or frozen["peft"].shared.phm_rule.requires_grad):
            raise AssertionError("Compacter's phm_rule takes a gradient")
        if dtype == torch.bfloat16:
            check_launches(kernels, f"{method} train step", want["step"],
                           lambda: first_step_grads(task, images, labels))
            out["bf16_with_bn"] = worst_cosine(task, images, labels)
            task.static = dataclasses.replace(task.static, use_bn=False)
        out["first_step_grads"].append({**compare_grads(task, images, labels, dtype),
                                        "use_bn": task.static.use_bn})

    n = len(serve_images)
    static, trainable, frozen, bn, preproc = build_classifier(seed=0, method=method,
                                                              num_classes=n)
    fit_prototype_head(static, trainable, frozen, bn, preproc, serve_images)
    serve = make_serving_fn(static, trainable, frozen, bn, preproc, device="cuda")
    batch = torch.from_numpy(serve_images).cuda()
    check_launches(kernels, f"{method} forward", want["forward"], lambda: serve(batch))
    out["serving"] = compare_plain(serve, batch, torch.arange(n).cuda(), torch.bfloat16)
    return out


def run_baseline_command(kernels, method: str, tmp: Path) -> tuple:
    """One baseline's command in phase 6's output directory, with its
    script's flags: LoRA with the sweep, the adapter and Compacter the final
    run only.  Exact launches from the steps and chunks it ran, the
    artifacts, the trainable count, and (LoRA) a sweep of its own, every
    trial trained; (Compacter) the frozen rule unchanged bit for bit.
    Returns (summary, batches)."""
    module = importlib.import_module(f"pevit_tpu_torch.commands.{method}_clip")
    cache_dir = tmp / "out" / "cifar-10" / "sweep_cache"
    before = {f: f.read_text() for f in cache_dir.iterdir()}
    options = {} if method == "lora" else BASELINE_FINAL
    times = {}
    reset_launches(kernels)
    t0 = time.perf_counter()
    with timed_command(times):
        best, info = module.main(command_argv(tmp, **options))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels)
    check_command_artifacts(tmp)
    (task, data, config), _ = times["run_method_call"]
    trials = 0
    if method == "lora":
        # the repair: LoRA's sweep opens a cache file of its own beside
        # KAdaptation's (left as it was) and trains each of its trials,
        # which the launches below count
        after = set(cache_dir.iterdir())
        if len(after) != 2 or any(f.read_text() != text for f, text in before.items()):
            raise AssertionError(f"sweep caches {sorted(f.name for f in after)}: want phase 6's, "
                                 "unchanged, and LoRA's own")
        (own,) = after - set(before)
        trials = len(check_sweep(own, info))
    elif len(list(cache_dir.iterdir())) != len(before):
        raise AssertionError(f"{method}: a run without the sweep wrote a sweep cache")
    chunks = [c["trials"] for c in times["calls"][:-1]]
    if sum(chunks) != trials:
        raise AssertionError(f"{method}: sweep chunks {chunks} for {trials} trials")
    batches = path_batches(task, times["calls"])
    want = expected_launches(batches)
    if launches != want:
        raise AssertionError(f"{method} command launches {launches}, want {want} for {trials} "
                             f"sweep trials in chunks {chunks} and the final run")
    head = task.static.head_dim * task.static.num_classes + task.static.num_classes
    if info["n_trainable_params"] != JAX_PEFT_TRAINABLE[method] + head:
        raise AssertionError(f"{method}: n_trainable_params {info['n_trainable_params']}, the "
                             f"JAX package counts {JAX_PEFT_TRAINABLE[method]} + {head}")
    if method == "compacter":
        # the final run is trial 0 of seed 0: the same generator redraws its rule
        rule = task.init_bundle(torch.Generator().manual_seed(0))[1]["peft"].shared.phm_rule
        if not torch.equal(task.last_bundle["peft"].shared.phm_rule, rule):
            raise AssertionError("Compacter's phm_rule changed in training")
    close_command_logs()
    epochs = config.TRAIN.END_EPOCH + config.TRAIN.EXTRA_FINAL_TRAIN_EPOCH
    final_s = times["run_method"] - times.get("sweep", 0.0)
    summary = {"best_acc": best, "best_lr": info["best_lr"], "best_wd": info["best_l2_lambda"],
               "n_trainable_params": info["n_trainable_params"], "n_params": info["n_params"],
               "sweep_trials": trials, "sweep_chunks": chunks, "launches": launches,
               "train_step_images": dict(batches["train"]),
               "eval_chunk_images": dict(batches["evals"]),
               "seconds": {"command": seconds, "text_features": times["text_features"],
                           "final_run": final_s},
               "final_train_images_per_s": (len(data[1]) + len(data[3])) * epochs / final_s}
    if trials:
        summary["seconds"].update(sweep=times["sweep"], sweep_per_trial=times["sweep"] / trials)
    return summary, batches


def run_baselines(kernels, gen, card: str, tmp: Path, clip, train_batch) -> tuple:
    """Phase 8; returns the launches and kernel rows of the baselines'
    command paths."""
    from pevit_tpu_torch.core import CLIPSpec

    launches, table = {}, {k.name: [] for k in kernels}
    res = CLIPSpec.vit_b32().vision.input_resolution
    # a serving batch of distinct seeded images, one class each
    serve_images = np.random.default_rng(8).integers(0, 256, (SERVE_BATCH, res, res, 3),
                                                     dtype=np.uint8)
    for method in BASELINES:
        t0 = time.perf_counter()
        checks = baseline_checks(kernels, method, clip, *train_batch, serve_images)
        print(f"{method}: {json.dumps(checks)} [{card}]", flush=True)
        summary, batches = run_baseline_command(kernels, method, tmp)
        launches[method] = summary["launches"]
        summary["seconds"]["method"] = time.perf_counter() - t0
        print(f"command {method}_clip: {json.dumps(summary)} [{card}]", flush=True)
        for name, rows_ in path_kernel_rows(gen, method, batches).items():
            table[name].extend(rows_)
            for r in rows_:
                print(f"{method} kernel {name} {json.dumps(r)} [{card}]", flush=True)
    return launches, table


# ---------------------------------------------------------------------------
# 9. the deployment path
# ---------------------------------------------------------------------------

EXPORT_BATCHES = (1, 8, 37, 256)
# the artifacts a deployment exports: name -> (bake_weights, quantize), bf16
EXPORT_MODES = {"baked-fp": (True, False), "baked-int8": (True, True),
                "args-fp": (False, False), "args-int8": (False, True)}
DAEMON_IMAGES = 37
# loads each artifact in a fresh interpreter that imports only the port, runs
# it on the card at each batch and prints the launches of every call
ARTIFACT_CHILD = r"""
import json, sys, time
import numpy as np, torch
from pevit_tpu_torch.ops import KERNELS
from pevit_tpu_torch.serve import exported_callable, load_exported
job = json.loads(sys.argv[1])
images = np.load(job["images"])
out, launches, load_s = {}, {}, {}
for name, art in job["artifacts"].items():
    t0 = time.perf_counter()
    weights = torch.load(art["weights"], weights_only=True) if art["weights"] else None
    call = exported_callable(load_exported(art["path"]), weights, device="cuda")
    torch.cuda.synchronize()
    load_s[name] = time.perf_counter() - t0
    for b in job["batches"]:
        for k in KERNELS:
            k.launches = 0
        logits = call(images[:b])
        torch.cuda.synchronize()
        launches[f"{name}/{b}"] = {k.name: k.launches for k in KERNELS}
        out[f"{name}/{b}"] = logits.float().cpu().numpy()
np.savez(job["out"], **out)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pevit_tpu"))
print(json.dumps({"launches": launches, "load_s": load_s, "leaked": leaked}))
"""


def python_child(*args, timeout: int = 600) -> subprocess.CompletedProcess:
    """``python3`` on ``args`` from the repository root, its output captured;
    raises on a non-zero exit with the child's error output."""
    proc = subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{args[:3]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc


def export_artifacts(static, trainable, frozen, bn, preproc, tmp: Path, images) -> dict:
    """Phase 9's artifacts: the four bf16 ones, traced on the card, and an
    fp32 baked one traced on the CPU from a CPU copy of the bundle; each
    saved as ``.pt2`` (a weights-as-args one with its ``serving_weights``).
    Returns the child's job."""
    from pevit_tpu_torch.serve import export_classifier, save_exported, serving_weights
    from pevit_tpu_torch.train import combine

    res = static.spec.vision.input_resolution
    job = {"images": str(tmp / "images.npy"), "out": str(tmp / "logits.npz"),
           "batches": list(EXPORT_BATCHES), "artifacts": {}, "seconds": {}}
    np.save(tmp / "images.npy", images)
    for name, (bake, quantize) in EXPORT_MODES.items():
        t0 = time.perf_counter()
        ep = export_classifier(static, trainable, frozen, bn, preproc, image_size=res,
                               bake_weights=bake, quantize=quantize, device="cuda")
        save_exported(ep, tmp / f"{name}.pt2")
        weights = None
        if not bake:
            weights = str(tmp / f"{name}.weights.pt")
            torch.save(serving_weights(trainable, frozen, bn, quantize=quantize), weights)
        job["artifacts"][name] = {"path": str(tmp / f"{name}.pt2"), "weights": weights}
        job["seconds"][name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = {k: None if m is None else copy.deepcopy(m).cpu()
           for k, m in combine(trainable, frozen).items()}
    ep = export_classifier(dataclasses.replace(static, compute_dtype="float32"), cpu,
                           {k: None for k in cpu}, {k: v.cpu() for k, v in bn.items()}, preproc,
                           image_size=res, device="cpu")
    save_exported(ep, tmp / "cpu-fp32.pt2")
    job["artifacts"]["cpu-fp32"] = {"path": str(tmp / "cpu-fp32.pt2"), "weights": None}
    job["seconds"]["cpu-fp32"] = time.perf_counter() - t0
    job["mb"] = {name: (tmp / f"{name}.pt2").stat().st_size / 1e6 for name in job["artifacts"]}
    return job


def check_artifacts(job: dict, layers: int, serve, serve_q, serve32) -> dict:
    """The child's logits against the in-process serving fns at the same
    batch (bf16: top-1 agreement 1.0 and within phase 4's bound; fp32
    within 1e-5 of the largest logit) and its launches: one of K1 and of K2
    a block and a call, none of K3.  Returns the calls and launches of each
    path."""
    t0 = time.perf_counter()
    proc = python_child("-c", ARTIFACT_CHILD, json.dumps(job))
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child["leaked"]:
        raise AssertionError(f"the artifact child imported {child['leaked']}")
    images = np.load(job["images"])
    checks = []
    calls = {"exported": collections.Counter(), "exported_fp32": collections.Counter()}
    launches = {path: collections.Counter() for path in calls}
    with np.load(job["out"]) as z:
        for key in z.files:
            got = z[key]
            name, b = key.split("/")
            b = int(b)
            want = {"baked-int8": serve_q, "args-int8": serve_q, "cpu-fp32": serve32}.get(
                name, serve)(images[:b]).float().cpu().numpy()
            err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
            top1 = float((got.argmax(1) == want.argmax(1)).mean())
            fp32 = name == "cpu-fp32"
            if got.shape != want.shape or not np.isfinite(got).all() or (
                    err > 1e-5 * scale if fp32 else (top1 < 1.0 or err > 1e-3 * scale)):
                raise AssertionError(f"{key}: artifact vs in-process max err {err} at scale "
                                     f"{scale}, top-1 agreement {top1}")
            call = child["launches"][key]
            if call != {"attention_fwd": layers, "fused_mlp_fwd": layers, "fused_mlp_bwd": 0}:
                raise AssertionError(f"{key}: launches {call}, want {layers} / {layers} / 0")
            path = "exported_fp32" if fp32 else "exported"
            calls[path][b] += 1
            launches[path].update(call)
            checks.append({"artifact": name, "images": b, "max_abs_err": err,
                           "max_abs_logit": scale, "top1_agreement": top1})
    return {"checks": checks, "calls": calls, "load_s": child["load_s"],
            "launches": {p: {k: n[k] for k in ("attention_fwd", "fused_mlp_fwd", "fused_mlp_bwd")}
                         for p, n in launches.items()},
            "child_s": time.perf_counter() - t0}


def exported_path_batches(calls: collections.Counter, dtype: str) -> dict:
    """The exported serving path as ``path_kernel_rows`` reads a command's:
    every call a forward (an eval chunk) of K1 and K2."""
    from pevit_tpu_torch.core import CLIPSpec

    vision = CLIPSpec.vit_b32().vision
    return {"dtype": dtype, "train": collections.Counter(), "evals": calls,
            "layers": vision.layers, "width": vision.width, "tokens": vision.seq_len,
            "fused_mlp": True, "fused_mlp_bwd": False}


# the daemon's config: phase 6's YAMLs and random weights of its seed
DAEMON_YAMLS = (REPO / "resources/datasets/cifar10.yaml", REPO / "resources/model/vitb32_CLIP.yaml")
DAEMON_OPTS = ["MODEL.PRETRAINED", "random"]


def start_daemon(tmp: Path):
    """``python -m pevit_tpu_torch.serve_daemon`` from phase 6's config and
    trained state (``TPU.CHECKPOINT_DIR``), exact padding, on a free port."""
    ds, model = DAEMON_YAMLS
    argv = ["-m", "pevit_tpu_torch.serve_daemon", "--ds", str(ds), "--model", str(model),
            "--weights-from", str(tmp / "ckpt"), "--pad-policy", "exact", "--port", "0",
            *DAEMON_OPTS]
    return subprocess.Popen([sys.executable, *argv], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def query_daemon(proc, tmp: Path, images) -> dict:
    """Phase 9, step 4: wait for the daemon's line, ask /healthz, POST the
    images twice (cold, then warm), hold the logits to the in-process
    serving fn of the same config and trained state, then stop the daemon
    with SIGINT."""
    import signal

    from pevit_tpu_torch.serve import make_serving_fn
    from pevit_tpu_torch.serve_daemon import config_from
    from pevit_tpu_torch.serving_loader import build_task, restore_into

    t0 = time.perf_counter()
    lines = []
    for line in proc.stdout:
        lines.append(line)
        m = re.search(r"serving on (http://\S+) ", line)
        if m:
            url = m.group(1)
            break
    else:
        raise RuntimeError(f"the daemon exited {proc.wait()}:\n{''.join(lines)[-4000:]}")
    wait_s = time.perf_counter() - t0
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    answers, ms = [], []
    for _ in range(2):
        t1 = time.perf_counter()
        answers.append(post_npy(url, images))
        ms.append((time.perf_counter() - t1) * 1e3)
    proc.send_signal(signal.SIGINT)
    rc = proc.wait(timeout=60)
    if rc != 0:
        raise RuntimeError(f"the daemon stopped with {rc}")
    config = config_from(*map(str, DAEMON_YAMLS), DAEMON_OPTS)
    task, static, trainable, frozen, bn = build_task(config, "kadaptation", 0, "cuda")
    restore_into(str(tmp / "ckpt"), trainable)
    serve = make_serving_fn(static, trainable, frozen, bn, task.preproc, device="cuda")
    want = serve(images).float().cpu().numpy()
    size = static.spec.vision.input_resolution
    if health != {"status": "ok", "image_size": size} or not all(
            np.array_equal(got, want) for got in answers):
        raise AssertionError(f"daemon: health {health}, logits max diff "
                             f"{[float(np.abs(got - want).max()) for got in answers]} from the "
                             "in-process serving fn")
    return {"health": health, "images": len(images), "logits": list(want.shape),
            "ready_s_after_the_exports": wait_s, "cold_request_ms": ms[0],
            "warm_request_ms": ms[1], "equal_to_in_process": True}


def run_serve_bench(artifact: str, num_classes: int, *options) -> list:
    """``python -m pevit_tpu_torch.tools.serve_bench`` briefly on a
    program-only artifact, its weights rebuilt from the daemon's model YAML
    (random weights, the PEFT factors at their zero init, as the reference's
    tool benches, so that the daemon arm's coalesced batches give the batch
    arms' logits); returns its JSON lines."""
    proc = python_child("-m", "pevit_tpu_torch.tools.serve_bench", "--artifact", artifact,
                        "--model", str(DAEMON_YAMLS[1]), "--images", "2048", "--reps", "2",
                        "--depths", "2,3", "--clients", "4", *options, *DAEMON_OPTS,
                        "DATASET.NUM_CLASSES", str(num_classes))
    return [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]


def flop_ledger(serve, serve_batch, clip, train_batch, serving_ips: float, peaks) -> dict:
    """FLOPs of a bf16 serving forward at batch 256 and of a KAdaptation
    train step at batch 128 (forward and backward), by the port's ledger;
    the serving MFU of phase 4's images/s against the bf16 peak."""
    from pevit_tpu_torch.utils.flops import step_flops

    fwd = step_flops(serve, serve_batch)
    task = make_task(clip, "bfloat16", dropout_p=0.5)
    step = step_flops(first_step_grads, task, *train_batch)
    per_image = fwd / len(serve_batch)
    return {"serving_forward_flop": fwd, "serving_gflop_per_image": per_image / 1e9,
            "train_step_flop": step, "train_gflop_per_image": step / len(train_batch[1]) / 1e9,
            "serving_images_per_s_phase4": serving_ips,
            "serving_mfu_bf16": per_image * serving_ips / (peaks.bf16_tflops * 1e12)}


def run_deployment(kernels, gen, card: str, tmp: Path, serving_ips: float, train_batch) -> tuple:
    """Phase 9; returns the launches and kernel rows of the exported path."""
    from pevit_tpu_torch.quant import tree_nbytes
    from pevit_tpu_torch.serve import make_serving_fn, serving_weights
    from pevit_tpu_torch.tools.quant_agreement import measure

    t_phase = time.perf_counter()
    steps, t_step = {}, [t_phase]

    def step_done(name):
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now

    daemon = start_daemon(tmp)
    try:
        # phase 4's tower, the head fitted to the served batch (phase 8's)
        static, trainable, frozen, bn, preproc = build_classifier(seed=0,
                                                                  num_classes=SERVE_BATCH)
        res = static.spec.vision.input_resolution
        images = np.random.default_rng(8).integers(0, 256, (SERVE_BATCH, res, res, 3),
                                                   dtype=np.uint8)
        fit_prototype_head(static, trainable, frozen, bn, preproc, images)
        job = export_artifacts(static, trainable, frozen, bn, preproc, tmp / "artifacts", images)
        print(f"exported {json.dumps({k: job[k] for k in ('mb', 'seconds')})} [{card}]",
              flush=True)
        step_done("classifier_and_exports")
        serve = make_serving_fn(static, trainable, frozen, bn, preproc, device="cuda")
        serve_q = make_serving_fn(static, trainable, frozen, bn, preproc, quantize=True,
                                  device="cuda")
        serve32 = make_serving_fn(dataclasses.replace(static, compute_dtype="float32"),
                                  trainable, frozen, bn, preproc, device="cuda")
        art = check_artifacts(job, static.spec.vision.layers, serve, serve_q, serve32)
        print(f"artifacts in a fresh process vs in-process: {json.dumps(art)} [{card}]",
              flush=True)
        step_done("fresh_process")
        daemon_out = query_daemon(daemon, tmp, images[:DAEMON_IMAGES])
        print(f"serve_daemon from phase 6's checkpoint: {json.dumps(daemon_out)} [{card}]",
              flush=True)
        step_done("daemon")
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()

    ratio = (tree_nbytes(serving_weights(trainable, frozen, bn)["bundle"])
             / tree_nbytes(serving_weights(trainable, frozen, bn, quantize=True)["bundle"]))
    agreement = measure("b32", SERVE_BATCH, SERVE_BATCH, "", torch.device("cuda"))
    if ratio <= 3.0 or agreement["top1_agreement"] < 15 / 16 or \
            agreement["max_rel_logit_err"] >= 0.06:
        raise AssertionError(f"int8: bundle ratio {ratio}, {agreement}")
    print(f"int8 vs fp: {json.dumps({'bundle_bytes_ratio': ratio, **agreement})} [{card}]",
          flush=True)
    step_done("int8_vs_fp")

    ledger = flop_ledger(serve, torch.from_numpy(images).cuda(), frozen["clip"], train_batch,
                         serving_ips, card_peaks())
    print(f"FLOP ledger: {json.dumps(ledger)} [{card}]", flush=True)
    step_done("flop_ledger")

    for name, options in (("args-fp", ()), ("args-int8", ("--quantize",))):
        for rec in run_serve_bench(job["artifacts"][name]["path"], static.num_classes, *options):
            print(f"serve_bench {name}: {json.dumps(rec)} [{card}]", flush=True)
    step_done("serve_bench")

    launches, table = {}, {k.name: [] for k in kernels}
    for path, dtype in (("exported", "bfloat16"), ("exported_fp32", "float32")):
        batches = exported_path_batches(art["calls"][path], dtype)
        launches[path] = art["launches"][path]
        if launches[path] != expected_launches(batches):
            raise AssertionError(f"{path}: launches {launches[path]} for calls "
                                 f"{dict(art['calls'][path])}")
        for name, rows_ in path_kernel_rows(gen, path, batches).items():
            table[name].extend(rows_)
            for r in rows_:
                print(f"{path} kernel {name} {json.dumps(r)} [{card}]", flush=True)
    step_done("kernel_rows")
    print(f"phase 9 seconds by step: {json.dumps(steps)}", flush=True)
    return launches, table, time.perf_counter() - t_phase


# ---------------------------------------------------------------------------
# 10. the auxiliary backbones
# ---------------------------------------------------------------------------

AUX_SEED = 3
# cut for the time limit: the aux commands train 2 + 1 epochs, not 10 + 40
AUX_EPOCHS = ("2", "1")
AUX_BATCH = 64  # each backbone's timed forward
AUX_EXPORT_BATCHES = (1, 8, 37)
# the first-step gradients that the head's train-mode BN cancels: the final
# LayerNorm's bias shifts every feature by one vector, which the BN takes
# out, so what either path computes for it is rounding noise
VIT_VANISHING = ("clip.norm.bias",)
# ... and its scale multiplies each feature by one factor, which the BN
# divides out up to its eps (1e-5): that gradient is about 1e-5 of the
# tower's largest and mostly rounding, so an attention computed in float64
# and rounded to float32 moves it by ~2.5e-3 of its own size against
# cuBLAS's (tools/fp32_grad_witness.py).  The kernel's gap on it is held to
# WITNESS_FACTOR x that witness's gap, measured in the same run on the same
# batch (``witness_gaps``)
VIT_WITNESSED = ("clip.norm.scale",)
WITNESS_FACTOR = 2.0


def aux_argv(tmp: Path, model: str, *options, epochs=AUX_EPOCHS) -> list:
    """A command's arguments on synthetic cifar-10 with a shipped model YAML
    (random weights unless ``options`` name a checkpoint); outputs in
    ``tmp``, the data in ``tmp``'s parent."""
    return ["--ds", str(REPO / "resources/datasets/cifar10.yaml"),
            "--model", str(REPO / "resources/model" / model), "--no-tuning", "True", *options,
            "DATASET.NUM_SAMPLES_PER_CLASS", "5", "DATASET.ALLOW_SYNTHETIC", "True",
            "DATASET.ROOT", str(tmp.parent / "data"), "OUTPUT_DIR", str(tmp / "out"),
            "TRAIN.END_EPOCH", epochs[0], "TRAIN.EXTRA_FINAL_TRAIN_EPOCH", epochs[1]]


def aux_config(model: str, *opts):
    from pevit_tpu_torch.serve_daemon import config_from

    return config_from(str(REPO / "resources/datasets/cifar10.yaml"),
                       str(REPO / "resources/model" / model), list(opts))


def aux_batches(task, calls: list, tokens: int, fused_mlp: bool, layers: int = 12) -> dict:
    """A command's batches (from its ``train_trials`` calls) over a backbone
    whose blocks are the CLIP blocks (``layers`` of them; 0 for an RN tower,
    which launches no kernel): the backbone runs in float32, so its kernels
    run their fp32 bodies; K2 only where the blocks take the fused MLP
    (DeCLIP's frozen tower), K3 never (no gradient crosses a fused MLP on
    these paths)."""
    train, evals = call_batches(calls)
    return {"dtype": "float32", "train": train, "evals": evals, "layers": layers, "width": 768,
            "tokens": tokens, "fused_mlp": fused_mlp, "fused_mlp_bwd": False}


def run_aux_command(kernels, module, argv: list, batches_of) -> tuple:
    """One command run: exact launches for the batches ``batches_of(task,
    calls)`` gives for its ``train_trials`` calls, and the predictions
    artifact.  Returns (summary, task, data, config, batches)."""
    times = {}
    reset_launches(kernels)
    t0 = time.perf_counter()
    with timed_command(times):
        best, info = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels)
    (task, data, config), _ = times["run_method_call"]
    batches = batches_of(task, times["calls"])
    if launches != expected_launches(batches):
        raise AssertionError(f"{config.MODEL.NAME} {module.__name__}: launches {launches}, "
                             f"want {expected_launches(batches)}")
    out = Path(config.OUTPUT_DIR) / "predictions"
    (artifact,) = out.glob("*/seed0_cifar-10.json")
    check_predictions(artifact, len(data[5]))
    summary = {"best_acc": best, "n_trainable_params": info["n_trainable_params"],
               "n_params": info["n_params"], "launches": launches,
               "train_step_images": dict(batches["train"]),
               "eval_chunk_images": dict(batches["evals"]),
               "seconds": {"command": seconds, "run_method": times["run_method"]}}
    close_command_logs()
    return summary, task, data, config, batches


def aux_forward(kernels, backbone, res: int, rng, *, tokens: int, fused: bool,
                layers: int = 12, width: int = 768, heads: int = 12) -> tuple:
    """One forward of ``backbone`` (``layers`` blocks of ``width``, in
    ``heads`` heads) at AUX_BATCH on the card: its launches (a K1 a block a
    forward, and a K2 where ``fused``), features finite and within 1e-4 of
    the plain path's, and feature images/s (median of 5 timed forwards
    after warm-up).  Returns (summary, batches)."""
    x = torch.from_numpy(rng.standard_normal((AUX_BATCH, res, res, 3)).astype(np.float32)).cuda()
    fwd = lambda: backbone.forward_features(backbone.params, x)
    with torch.no_grad():
        reset_launches(kernels)
        got = fwd()
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        with plain_path():
            want = fwd()
        ms = time_ms(fwd, reps=5)
    batches = {"dtype": "float32", "train": collections.Counter(),
               "evals": collections.Counter({AUX_BATCH: 1}), "layers": layers, "width": width,
               "heads": heads, "head_dim": width // heads, "tokens": tokens, "fused_mlp": fused,
               "fused_mlp_bwd": False}
    if launches != expected_launches(batches):
        raise AssertionError(f"{backbone.name} forward: launches {launches}, "
                             f"want {expected_launches(batches)}")
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if got.shape != (AUX_BATCH, backbone.feat_dim) or not torch.isfinite(got).all() \
            or err > 1e-4 * scale:
        raise AssertionError(f"{backbone.name} features {tuple(got.shape)}: kernel vs plain "
                             f"{err} > 1e-4 * {scale}")
    return ({"feat_dim": backbone.feat_dim, "launches": launches, "max_abs_err_vs_plain": err,
             "max_abs": scale, "ms": ms, "feature_images_per_s": AUX_BATCH / ms * 1e3}, batches)


def write_timm_checkpoint(path: Path):
    """A timm-layout ViT-B/16 state dict from seeded tensors (N(0, 0.02)
    weights, LayerNorms near the identity), saved with ``torch.save``.
    Returns the reference tree that it must load as."""
    from pevit_tpu_torch.models.vit import normalize_vit_state_dict, timm_state_dict_to_params

    rng = np.random.default_rng(AUX_SEED)
    r = lambda *s, std=0.02: (rng.standard_normal(s, dtype=np.float32) * std)
    w, p, n = 768, 16, 197
    sd = {"patch_embed.proj.weight": r(w, 3, p, p), "patch_embed.proj.bias": r(w),
          "cls_token": r(1, 1, w), "pos_embed": r(1, n, w),
          "norm.weight": 1 + r(w, std=0.1), "norm.bias": r(w)}
    for i in range(12):
        b = f"blocks.{i}"
        sd.update({f"{b}.norm1.weight": 1 + r(w, std=0.1), f"{b}.norm1.bias": r(w),
                   f"{b}.attn.qkv.weight": r(3 * w, w), f"{b}.attn.qkv.bias": r(3 * w),
                   f"{b}.attn.proj.weight": r(w, w), f"{b}.attn.proj.bias": r(w),
                   f"{b}.norm2.weight": 1 + r(w, std=0.1), f"{b}.norm2.bias": r(w),
                   f"{b}.mlp.fc1.weight": r(4 * w, w), f"{b}.mlp.fc1.bias": r(4 * w),
                   f"{b}.mlp.fc2.weight": r(w, 4 * w), f"{b}.mlp.fc2.bias": r(w)})
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return timm_state_dict_to_params(normalize_vit_state_dict(sd))[0]


def same_tree(module, tree: dict, what: str) -> None:
    """Every tensor of ``module`` equals ``tree``'s (the reference layout)
    bit for bit."""
    from pevit_tpu_torch.bridge import _flatten, module_to_jax

    got, want = _flatten(module_to_jax(module)), _flatten(tree)
    bad = [k for k in want if k not in got or not np.array_equal(got[k], want[k])]
    if bad or got.keys() != want.keys():
        raise AssertionError(f"{what}: {len(bad)} of {len(want)} leaves differ, e.g. {bad[:3]}")


def aux_vit(kernels, gen, card: str, tmp: Path, rng) -> tuple:
    """10a: the timm checkpoint through get_model; the MAE linear probe; the
    ViT-B/16 finetune with first-step gradients; one forward of ViT-B/32,
    DeiT-B/16 and MoCo-v3 B/16; the probe's classifier exported with
    ``forward_fn`` and run in a fresh process."""
    from pevit_tpu_torch.commands import finetune, linear_probe
    from pevit_tpu_torch.models import get_model

    out, paths = {}, {}
    ckpt = tmp / "vit_base_patch16_224.pth"
    t0 = time.perf_counter()
    tree = write_timm_checkpoint(ckpt)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vit16 = get_model(aux_config("vit_base_patch16_224.yaml", "TEST.MODEL_FILE", str(ckpt)),
                      device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same_tree(vit16.params, tree, "get_model from a timm checkpoint")
    from pevit_tpu_torch.bridge import _flatten

    out["timm_checkpoint"] = {"write_s": write_s, "load_s": load_s,
                              "file_bytes": ckpt.stat().st_size, "leaves": len(_flatten(tree))}
    out["vit_base_patch16_224"], paths["aux_forward_vit_b16"] = aux_forward(
        kernels, vit16, 224, rng, tokens=197, fused=False)
    del vit16

    probe, task, data, config, paths["aux_mae_probe"] = run_aux_command(
        kernels, linear_probe, aux_argv(tmp / "mae", "mae_vitb16.yaml", "--lr", "0.01", "--l2",
                                        "0.0001"),
        lambda t, calls: aux_batches(t, calls, 197, fused_mlp=False))
    if config.MODEL.SPEC.GLOBAL_POOL is not False or task.backbone is None:
        raise AssertionError("the MAE probe kept its global pool")
    out["mae_linear_probe"] = probe
    out["mae_export"], paths["aux_exported"] = aux_export(task, data, tmp)

    ft, ftask, fdata, _, paths["aux_vit_finetune"] = run_aux_command(
        kernels, finetune, aux_argv(tmp / "vit_ft", "vit_base_patch16_224.yaml", "--lr", "1e-5",
                                    "--l2", "0.0001", "TEST.MODEL_FILE", str(ckpt)),
        lambda t, calls: aux_batches(t, calls, 197, fused_mlp=False))
    same_tree(ftask.clip, tree, "the pretrained ViT-B/16 after the finetune run")
    images, labels = fdata[0][:AUX_BATCH], fdata[1][:AUX_BATCH]
    ft["first_step_grads"] = []
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        variant = copy.copy(ftask)
        variant.static = dataclasses.replace(ftask.static, compute_dtype=dtype_name)
        limits = None
        if dtype == torch.float32:
            witness = witness_gaps(variant, images, labels, VIT_WITNESSED)
            limits = {n: WITNESS_FACTOR * gap for n, gap in witness.items()}
        grads = compare_grads(variant, images, labels, dtype, VIT_VANISHING, limits)
        if limits:
            for n, held in grads["held_to_limits"].items():
                held["witness_gap"] = witness[n]
        ft["first_step_grads"].append(grads)
    out["vit_finetune"] = ft
    del ftask, task

    for name, model, tokens in (("vit_base_patch32_224", "vit_base_patch32_224.yaml", 50),
                                ("deit_base_patch16_224", "deit_base_patch16_224.yaml", 197),
                                ("mocov3_vitb16", "mocov3_vitb16.yaml", 197)):
        backbone = get_model(aux_config(model), device="cuda")
        out[name], paths[f"aux_forward_{name}"] = aux_forward(kernels, backbone, 224, rng,
                                                              tokens=tokens, fused=False)
    for name, summary in out.items():
        print(f"aux {name}: {json.dumps(summary)} [{card}]", flush=True)
    return paths


def aux_export(task, data, tmp: Path) -> tuple:
    """The MAE probe's classifier exported with its backbone's forward,
    baked, and run in a fresh process that imports only the port: logits
    within 1e-5 of the in-process serving forward, 12 K1 launches a call."""
    from pevit_tpu_torch.serve import export_classifier, make_serving_fn, save_exported
    from pevit_tpu_torch.train import partition, trainable_pred

    trainable, frozen = partition(task.last_bundle, trainable_pred(task.static))
    bn = task.last_state.bn
    serve = make_serving_fn(task.static, trainable, frozen, bn, task.preproc,
                            forward_fn=task._forward_fn, device="cuda")
    t0 = time.perf_counter()
    ep = export_classifier(task.static, trainable, frozen, bn, task.preproc, image_size=224,
                           device="cuda", forward_fn=task._forward_fn)
    save_exported(ep, tmp / "mae_probe.pt2")
    export_s = time.perf_counter() - t0
    images = data[4][:max(AUX_EXPORT_BATCHES)].cpu().numpy()
    np.save(tmp / "mae_images.npy", images)
    job = {"images": str(tmp / "mae_images.npy"), "out": str(tmp / "mae_logits.npz"),
           "batches": list(AUX_EXPORT_BATCHES),
           "artifacts": {"mae-probe": {"path": str(tmp / "mae_probe.pt2"), "weights": None}}}
    child = json.loads(python_child("-c", ARTIFACT_CHILD, json.dumps(job)).stdout
                       .strip().splitlines()[-1])
    if child["leaked"]:
        raise AssertionError(f"the artifact child imported {child['leaked']}")
    checks, calls = [], collections.Counter()
    with np.load(job["out"]) as z:
        for b in AUX_EXPORT_BATCHES:
            got, want = z[f"mae-probe/{b}"], serve(images[:b]).float().cpu().numpy()
            err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
            call = child["launches"][f"mae-probe/{b}"]
            if got.shape != want.shape or err > 1e-5 * scale:
                raise AssertionError(f"exported MAE probe at {b}: max err {err} at {scale}")
            if call != {"attention_fwd": 12, "fused_mlp_fwd": 0, "fused_mlp_bwd": 0}:
                raise AssertionError(f"exported MAE probe at {b}: launches {call}")
            calls[b] += 1
            checks.append({"images": b, "max_abs_err": err, "max_abs_logit": scale})
    batches = {"dtype": "float32", "train": collections.Counter(), "evals": calls, "layers": 12,
               "width": 768, "tokens": 197, "fused_mlp": False, "fused_mlp_bwd": False}
    return ({"export_s": export_s, "mb": (tmp / "mae_probe.pt2").stat().st_size / 1e6,
             "load_s": child["load_s"], "checks": checks,
             "launches": expected_launches(batches)}, batches)


def aux_declip(kernels, gen, card: str, tmp: Path, rng) -> tuple:
    """10b: the DeCLIP probe with the text-initialised head (text features
    on the card against a CPU copy of the tower), FILIP's dense features,
    and one finetune step of SLIP."""
    from pevit_tpu_torch.commands import finetune, linear_probe
    from pevit_tpu_torch.commands._common import backbone_text_features
    from pevit_tpu_torch.models import get_model

    out, paths = {}, {}
    probe, task, _, config, paths["aux_declip_probe"] = run_aux_command(
        kernels, linear_probe, aux_argv(tmp / "declip", "vitb32_DeCLIP.yaml", "--lr", "0.01",
                                        "--l2", "0.0001", "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER",
                                        "True"),
        lambda t, calls: aux_batches(t, calls, 50, fused_mlp=True))
    card_w = task.text_init_weights
    cpu = dataclasses.replace(task.backbone, params=copy.deepcopy(task.backbone.params).cpu())
    cpu_w = backbone_text_features(config, cpu)
    err, scale = float(np.abs(card_w - cpu_w).max()), float(np.abs(cpu_w).max())
    if card_w.shape != (3072, 10) or err > 1e-4 * scale:
        raise AssertionError(f"DeCLIP text head {card_w.shape}: card vs CPU {err} > 1e-4 * {scale}")
    probe["text_head_card_vs_cpu"] = {"max_abs_err": err, "max_abs": scale}
    out["declip_linear_probe"] = probe
    out["vitb32_DeCLIP"], paths["aux_forward_declip"] = aux_forward(
        kernels, task.backbone, 224, rng, tokens=50, fused=True)
    del task, cpu

    filip = get_model(aux_config("vitb32_FILIP.yaml"), device="cuda")
    if filip.feat_dim != 49 * 256:
        raise AssertionError(f"FILIP feat_dim {filip.feat_dim}, want 49 x 256")
    out["vitb32_FILIP"], paths["aux_forward_filip"] = aux_forward(kernels, filip, 224, rng,
                                                                  tokens=50, fused=True)
    del filip

    slip, stask, _, _, paths["aux_slip_finetune"] = run_aux_command(
        kernels, finetune, aux_argv(tmp / "slip", "vitb32_SLIP.yaml", "--lr", "1e-5", "--l2",
                                    "0.0001", epochs=("1", "0")),
        lambda t, calls: aux_batches(t, calls, 50, fused_mlp=False))
    if slip["launches"]["fused_mlp_fwd"] or sum(paths["aux_slip_finetune"]["train"].values()) != 1:
        raise AssertionError(f"SLIP finetune: {slip['launches']}, steps "
                             f"{paths['aux_slip_finetune']['train']}")
    out["slip_finetune"] = slip
    for name, summary in out.items():
        print(f"aux {name}: {json.dumps(summary)} [{card}]", flush=True)
    return paths


def write_rn50_checkpoint(path: Path):
    """A seeded RN50 CLIP (random BatchNorm running statistics) written as an
    OpenAI-layout state dict; returns the CLIP, on the CPU."""
    from pevit_tpu_torch.ckpt import clip_to_state_dict
    from pevit_tpu_torch.core import CLIPSpec, init_clip_params
    from pevit_tpu_torch.core.clip import TextSpec
    from pevit_tpu_torch.core.resnet import RN_SPECS, BatchNorm

    g = torch.Generator().manual_seed(AUX_SEED)
    spec = CLIPSpec(embed_dim=1024, vision_rn=RN_SPECS["RN50"], text=TextSpec(output_dim=1024))
    clip = init_clip_params(g, spec, device="cpu")
    with torch.no_grad():
        for m in clip.visual.modules():
            if isinstance(m, BatchNorm):
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, generator=g))
                m.var.copy_(0.5 + torch.rand(m.var.shape, generator=g))
    torch.save(clip_to_state_dict(clip), path)
    return clip


def aux_rn50(kernels, card: str, tmp: Path, rng) -> tuple:
    """10c: an OpenAI-layout RN50 checkpoint loaded bit for bit, then
    zero-shot and the linear probe on it: no kernel launches (the
    attention pool is plain, as in the reference)."""
    from pevit_tpu_torch.ckpt import load_clip
    from pevit_tpu_torch.commands import linear_probe, zeroshot
    from pevit_tpu_torch.core import encode_image

    out, paths = {}, {}
    ckpt = tmp / "RN50.pt"
    t0 = time.perf_counter()
    src = write_rn50_checkpoint(ckpt)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clip, spec = load_clip("RN50", checkpoint_path=str(ckpt), device="cuda")
    torch.cuda.synchronize()
    out["checkpoint"] = {"write_s": write_s, "load_s": time.perf_counter() - t0,
                         "file_bytes": ckpt.stat().st_size}
    same_tensors(clip, src, "load_clip from an RN50 checkpoint")
    x = torch.from_numpy(rng.standard_normal((AUX_BATCH, 224, 224, 3)).astype(np.float32)).cuda()
    with torch.no_grad():
        reset_launches(kernels)
        feats = encode_image(clip, x, spec=spec)
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        ms = time_ms(lambda: encode_image(clip, x, spec=spec), reps=5)
    cpu = encode_image(copy.deepcopy(clip).cpu(), x[:8].cpu(), spec=spec)
    err, scale = (feats[:8].cpu() - cpu).abs().max().item(), cpu.abs().max().item()
    if any(launches.values()) or feats.shape != (AUX_BATCH, 1024) or err > 1e-4 * scale:
        raise AssertionError(f"RN50 forward: launches {launches}, {tuple(feats.shape)}, card vs "
                             f"CPU {err} > 1e-4 * {scale}")
    out["RN50"] = {"launches": launches, "max_abs_err_card_vs_cpu": err, "max_abs": scale,
                   "ms": ms, "feature_images_per_s": AUX_BATCH / ms * 1e3}
    del clip, src

    argv = ["--ds", str(REPO / "resources/datasets/cifar10.yaml"),
            "--model", str(REPO / "resources/model/vitb32_CLIP.yaml"), "MODEL.NAME", "RN50",
            "MODEL.PRETRAINED", str(ckpt), "DATASET.ALLOW_SYNTHETIC", "True",
            "DATASET.ROOT", str(tmp / "data"), "OUTPUT_DIR", str(tmp / "rn_zs" / "out")]
    reset_launches(kernels)
    t0 = time.perf_counter()
    result = zeroshot.main(argv)
    torch.cuda.synchronize()
    zs_launches = read_launches(kernels)
    if any(zs_launches.values()):
        raise AssertionError(f"RN50 zero-shot launched {zs_launches}")
    out["zeroshot"] = {"result": result, "launches": zs_launches,
                       "seconds": time.perf_counter() - t0}
    paths["aux_rn50_zeroshot"] = {"train": {}, "evals": {}, "layers": 0, "fused_mlp": False,
                                  "fused_mlp_bwd": False}
    close_command_logs()
    out["linear_probe"], _, _, _, paths["aux_rn50_probe"] = run_aux_command(
        kernels, linear_probe, aux_argv(tmp / "rn", "vitb32_CLIP.yaml", "--lr", "0.01", "--l2",
                                        "0.0001", "MODEL.NAME", "RN50", "MODEL.PRETRAINED",
                                        str(ckpt)),
        lambda t, calls: aux_batches(t, calls, 0, fused_mlp=False, layers=0))
    for name, summary in out.items():
        print(f"aux RN50 {name}: {json.dumps(summary)} [{card}]", flush=True)
    return paths


def write_clip_swin_checkpoint(path: Path) -> dict:
    """A CLIP-Swin-T state dict in the reference's layout (clip_swin.py:
    153-260: the official Swin keys under ``visual.``, CLIP's text tower
    under ``text.``, the bare projections and ``logit_scale``) from seeded
    tensors (N(0, 0.02), LayerNorms near the identity), at
    ``clip_swin_tiny.yaml``'s widths, saved with ``torch.save``.  Returns
    the reference tree that it must load as."""
    from pevit_tpu_torch.models.swin import clip_swin_state_dict_to_params, swin_tiny

    rng = np.random.default_rng(AUX_SEED)
    r = lambda *s, std=0.02: (rng.standard_normal(s, dtype=np.float32) * std)
    ln = lambda pre, n: {f"{pre}.weight": 1 + r(n, std=0.1), f"{pre}.bias": r(n)}
    spec, tw = swin_tiny(), 512
    sd = {"visual.patch_embed.proj.weight": r(96, 3, 4, 4), "visual.patch_embed.proj.bias": r(96),
          **ln("visual.patch_embed.norm", 96), **ln("visual.norm", 768)}
    for i, (depth, heads) in enumerate(zip(spec.depths, spec.num_heads)):
        dim, win = spec.stage_dim(i), spec.stage_window(i)
        for b in range(depth):
            pre = f"visual.layers.{i}.blocks.{b}"
            sd.update({**ln(f"{pre}.norm1", dim), **ln(f"{pre}.norm2", dim),
                       f"{pre}.attn.qkv.weight": r(3 * dim, dim), f"{pre}.attn.qkv.bias": r(3 * dim),
                       f"{pre}.attn.proj.weight": r(dim, dim), f"{pre}.attn.proj.bias": r(dim),
                       f"{pre}.attn.relative_position_bias_table": r((2 * win - 1) ** 2, heads),
                       f"{pre}.attn.relative_position_index": np.zeros((win * win,) * 2, np.int64),
                       f"{pre}.mlp.fc1.weight": r(4 * dim, dim), f"{pre}.mlp.fc1.bias": r(4 * dim),
                       f"{pre}.mlp.fc2.weight": r(dim, 4 * dim), f"{pre}.mlp.fc2.bias": r(dim)})
        if i < spec.num_stages - 1:
            sd.update({**ln(f"visual.layers.{i}.downsample.norm", 4 * dim),
                       f"visual.layers.{i}.downsample.reduction.weight": r(2 * dim, 4 * dim)})
    sd.update({"text.token_embedding.weight": r(49408, tw), "text.positional_embedding":
               r(77, tw, std=0.01), **ln("text.ln_final", tw), "text_projection": r(tw, 512),
               "vision_projection": r(768, 512), "logit_scale": np.float32(4.6052)})
    for i in range(12):
        pre = f"text.resblocks.{i}"
        sd.update({**ln(f"{pre}.ln_1", tw), **ln(f"{pre}.ln_2", tw),
                   f"{pre}.attn.in_proj_weight": r(3 * tw, tw), f"{pre}.attn.in_proj_bias": r(3 * tw),
                   f"{pre}.attn.out_proj.weight": r(tw, tw), f"{pre}.attn.out_proj.bias": r(tw),
                   f"{pre}.mlp.c_fc.weight": r(4 * tw, tw), f"{pre}.mlp.c_fc.bias": r(4 * tw),
                   f"{pre}.mlp.c_proj.weight": r(tw, 4 * tw), f"{pre}.mlp.c_proj.bias": r(tw)})
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    return clip_swin_state_dict_to_params(sd)[0]


def swin_forward_check(kernels, backbone, rng) -> tuple:
    """One fp32 forward of a Swin backbone at AUX_BATCH, 224 px: no kernel
    launch (window attention and the MLP are plain, as in the reference),
    features finite and, on 8 images, within 1e-4 of a CPU copy's (TF32
    off), and feature images/s (median of 5 CUDA-event timings)."""
    x = torch.from_numpy(rng.standard_normal((AUX_BATCH, 224, 224, 3)).astype(np.float32)).cuda()
    fwd = lambda: backbone.forward_features(backbone.params, x)
    with torch.no_grad():
        reset_launches(kernels)
        feats = fwd()
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        ms = time_ms(fwd, reps=5)
        cpu = copy.deepcopy(backbone.params).cpu()
        want = backbone.forward_features(cpu, x[:8].cpu())
    err, scale = (feats[:8].cpu() - want).abs().max().item(), want.abs().max().item()
    if any(launches.values()) or feats.shape != (AUX_BATCH, backbone.feat_dim) \
            or not torch.isfinite(feats).all() or err > 1e-4 * scale:
        raise AssertionError(f"{backbone.name} forward: launches {launches}, "
                             f"{tuple(feats.shape)}, card vs CPU {err} > 1e-4 * {scale}")
    return ({"feat_dim": backbone.feat_dim, "launches": launches,
             "max_abs_err_card_vs_cpu": err, "max_abs": scale, "ms": ms,
             "feature_images_per_s": AUX_BATCH / ms * 1e3},
            {"train": {}, "evals": {}, "layers": 0, "fused_mlp": False, "fused_mlp_bwd": False})


@contextlib.contextmanager
def stochastic_forwards():
    """A list that gets one entry for each call of a backbone's train-mode
    forward (``forward_features_train``) by the tasks made inside the block."""
    from pevit_tpu_torch.train import TrainTask

    calls, init = [], TrainTask.__init__

    def spy(self, *a, **k):
        backbone = k.get("backbone")
        if backbone is not None and backbone.forward_features_train is not None:
            fwd = backbone.forward_features_train

            def counted(p, x, generator, trials=0):
                calls.append(generator is not None)
                return fwd(p, x, generator, trials=trials)

            backbone.forward_features_train = counted
        init(self, *a, **k)

    TrainTask.__init__ = spy
    try:
        yield calls
    finally:
        TrainTask.__init__ = init


def aux_swin(kernels, card: str, tmp: Path, rng) -> tuple:
    """10d: a CLIP-Swin-T checkpoint in the reference's layout loaded by
    ``get_model`` bit for bit; one fp32 forward each of ``clip_swin_tiny``
    and a ``cls_swin_tiny`` classifier (card vs CPU); ``linear_probe`` on
    ``clip_swin_tiny`` with the text-initialised head (text features on the
    card against a CPU copy); ``finetune`` on it with VISION.DROP_PATH_RATE
    0.1 (which CLIP-Swin does not consume, as in the reference) and on
    ``cls_swin_tiny`` with DROP_PATH_RATE 0.1, whose train steps take the
    stochastic forward.  No path launches a kernel."""
    from pevit_tpu_torch.commands import finetune, linear_probe
    from pevit_tpu_torch.commands._common import backbone_text_features
    from pevit_tpu_torch.models import get_model

    out, paths = {}, {}
    ckpt = tmp / "clip_swin_tiny.pt"
    t0 = time.perf_counter()
    tree = write_clip_swin_checkpoint(ckpt)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clip_swin = get_model(aux_config("clip_swin_tiny.yaml", "TEST.MODEL_FILE", str(ckpt)),
                          device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same_tree(clip_swin.params, tree, "get_model from a CLIP-Swin checkpoint")
    out["clip_swin_checkpoint"] = {"write_s": write_s, "load_s": load_s,
                                   "file_bytes": ckpt.stat().st_size}
    out["clip_swin_tiny"], paths["aux_forward_clip_swin"] = swin_forward_check(
        kernels, clip_swin, rng)
    del clip_swin
    cls_yaml = tmp / "cls_swin_tiny.yaml"
    cls_yaml.write_text("MODEL:\n  NAME: cls_swin_tiny\n  SPEC:\n    DROP_PATH_RATE: 0.1\n")
    cls_swin = get_model(aux_config(str(cls_yaml)), device="cuda")
    if cls_swin.feat_dim != 768 or cls_swin.forward_features_train is None:
        raise AssertionError(f"cls_swin_tiny: feat_dim {cls_swin.feat_dim}, no train forward")
    out["cls_swin_tiny"], paths["aux_forward_cls_swin"] = swin_forward_check(kernels, cls_swin,
                                                                             rng)
    del cls_swin

    no_kernel = lambda t, calls: aux_batches(t, calls, 0, fused_mlp=False, layers=0)
    probe, task, _, config, paths["aux_clip_swin_probe"] = run_aux_command(
        kernels, linear_probe, aux_argv(tmp / "swin_probe", "clip_swin_tiny.yaml", "--lr", "0.01",
                                        "--l2", "0.0001", "TEST.MODEL_FILE", str(ckpt),
                                        "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER", "True"), no_kernel)
    card_w = task.text_init_weights
    cpu = dataclasses.replace(task.backbone, params=copy.deepcopy(task.backbone.params).cpu())
    cpu_w = backbone_text_features(config, cpu)
    err, scale = float(np.abs(card_w - cpu_w).max()), float(np.abs(cpu_w).max())
    if card_w.shape != (512, 10) or err > 1e-4 * scale:
        raise AssertionError(f"CLIP-Swin text head {card_w.shape}: card vs CPU {err} > 1e-4 * "
                             f"{scale}")
    probe["text_head_card_vs_cpu"] = {"max_abs_err": err, "max_abs": scale}
    out["clip_swin_linear_probe"] = probe
    del task, cpu

    ft_yaml = tmp / "clip_swin_tiny_dp.yaml"
    text = (REPO / "resources/model/clip_swin_tiny.yaml").read_text()
    ft_yaml.write_text(text.replace("DROP_PATH_RATE: 0.0", "DROP_PATH_RATE: 0.1"))
    for name, yaml, options in (("clip_swin_finetune", ft_yaml, ("TEST.MODEL_FILE", str(ckpt))),
                                ("cls_swin_finetune", cls_yaml, ())):
        with stochastic_forwards() as calls:
            ft, *_, paths[f"aux_{name}"] = run_aux_command(
                kernels, finetune, aux_argv(tmp / name, str(yaml), "--lr", "1e-5", "--l2",
                                            "0.0001", *options), no_kernel)
        steps = sum(paths[f"aux_{name}"]["train"].values())
        ft["stochastic_train_forwards"] = len(calls)
        if len(calls) != (steps if name == "cls_swin_finetune" else 0) or not all(calls):
            raise AssertionError(f"{name}: {len(calls)} stochastic forwards for {steps} steps")
        out[name] = ft
    for name, summary in out.items():
        print(f"aux swin {name}: {json.dumps(summary)} [{card}]", flush=True)
    return paths


def run_aux_backbones(kernels, gen, card: str) -> tuple:
    """Phase 10; returns the launches and kernel rows of its paths."""
    launches, table = {}, {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}
    rng = np.random.default_rng(AUX_SEED)
    t_phase, steps = time.perf_counter(), {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aux_") as tmp:
        tmp = Path(tmp)
        paths = {}
        for name, fn in (("vit", lambda: aux_vit(kernels, gen, card, tmp, rng)),
                         ("declip", lambda: aux_declip(kernels, gen, card, tmp, rng)),
                         ("rn50", lambda: aux_rn50(kernels, card, tmp, rng)),
                         ("swin", lambda: aux_swin(kernels, card, tmp, rng))):
            t0 = time.perf_counter()
            paths.update(fn())
            steps[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for path, batches in paths.items():
        launches[path] = expected_launches(batches) if batches["layers"] else \
            {k.name: 0 for k in kernels}
        if not batches["layers"]:
            continue
        for name, rows_ in path_kernel_rows(gen, path, batches).items():
            table[name].extend(rows_)
            for r in rows_:
                print(f"{path} kernel {name} {json.dumps(r)} [{card}]", flush=True)
    steps["kernel_rows"] = time.perf_counter() - t0
    print(f"phase 10 seconds by step: {json.dumps(steps)}", flush=True)
    return launches, table, time.perf_counter() - t_phase


# ---------------------------------------------------------------------------
# 11. streaming: a train split in host memory
# ---------------------------------------------------------------------------

STREAM_SEED = 5
# (a) right: 650 train (5 steps of 128 and a tail of 10) and 160 val images
# (chunks of 64, 64, 32), fp32, 2 trials x 2 epochs, against the preloaded
# path handed the streamed orders
STREAM_RIGHT = (650, 160, [(1e-3, 1e-4), (3e-4, 1e-2)], 2)
# (b) full size: 28,000 images = 4.21 GB at the default 4.0 GB limit, bf16
# batch 128 (218 steps of 128 and a tail of 96), a 64-image val split, on a
# seeded ViT-B/32 tower of half its depth (a cut for the time limit: the
# split cannot shrink below the limit, the depth halves each epoch's card
# work)
STREAM_FULL, STREAM_VAL, STREAM_FULL_LAYERS = 28_000, 64, 6


@contextlib.contextmanager
def spied_runners():
    """The ``StreamingEpochRunner`` objects made inside the block."""
    from pevit_tpu_torch.train import streaming

    made, init = [], streaming.StreamingEpochRunner.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    streaming.StreamingEpochRunner.__init__ = spy
    try:
        yield made
    finally:
        streaming.StreamingEpochRunner.__init__ = init


def set_device_limit(task, gb: float) -> None:
    task.config.defrost()
    task.config.TPU.MAX_DEVICE_DATA_GB = gb
    task.config.freeze()


def noisy_split(prototypes, n: int, rng) -> tuple:
    """``n`` noisy copies of the prototypes, labelled with their class."""
    labels = (np.arange(n) % len(prototypes)).astype(np.int32)
    noise = rng.integers(-8, 9, (n,) + prototypes.shape[1:], dtype=np.int16)
    return np.clip(prototypes[labels].astype(np.int16) + noise, 0, 255).astype(np.uint8), labels


def stream_batches(n_train: int, n_val: int, batch: int, chunk: int, epochs: int, dtype: str,
                   trials: int = 1, layers: int = 12) -> dict:
    """A streamed run's batches on a ViT-B/32 tower of ``layers`` blocks:
    ``epochs`` of full batches and a natural tail (one of a single image
    skipped), eval chunks and a natural remainder, each step and chunk one
    launch a block for the batch of ``trials`` at ``trials`` times the
    images."""
    train, evals = collections.Counter(), collections.Counter()
    train[trials * batch] += epochs * (n_train // batch)
    if n_train % batch > 1:
        train[trials * (n_train % batch)] += epochs
    evals[trials * chunk] += epochs * (n_val // chunk)
    if n_val % chunk:
        evals[trials * (n_val % chunk)] += epochs
    return {"dtype": dtype, "train": +train, "evals": +evals, "layers": layers, "width": 768,
            "tokens": 50, "fused_mlp": True, "fused_mlp_bwd": True}


def stream_right(kernels, clip, prototypes, rng) -> tuple:
    """11a: the streamed run of 2 trials against the preloaded path given
    the same orders, fp32 and dropout 0: every epoch's val logits, exact
    launches, and the split's bytes crossing once an epoch for both trials."""
    import pevit_tpu_torch.train.trainer as trainer
    from pevit_tpu_torch.train import combine
    from pevit_tpu_torch.train.streaming import epoch_order

    n_train, n_val, hparams, epochs = STREAM_RIGHT
    images, labels = noisy_split(prototypes, n_train, rng)
    val, val_labels = noisy_split(prototypes, n_val, rng)
    task = make_task(clip, "float32", 0.0)
    set_device_limit(task, 0.5 * images.nbytes / 1e9)
    seen, softmax = [], trainer._softmax
    trainer._softmax = lambda z: (seen.append(z), softmax(z))[1]
    try:
        with spied_runners() as runners:
            reset_launches(kernels)
            t0 = time.perf_counter()
            res = task.train_trials(hparams, images, labels, val, val_labels, end_epoch=epochs,
                                    seed=STREAM_SEED, keep_logits=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_launches(kernels)
    finally:
        trainer._softmax = softmax
    (runner,) = runners
    batches = stream_batches(n_train, n_val, TRAIN_BATCH, task.eval_chunk, epochs, "float32",
                             trials=len(hparams))
    if launches != expected_launches(batches):
        raise AssertionError(f"streamed run launches {launches}, want "
                             f"{expected_launches(batches)}")
    steps = sum(batches["train"].values())  # one batched step a batch for both trials
    if (runner.trials != len(hparams) or runner.batches != steps
            or runner.h2d_bytes != epochs * images.nbytes):
        raise AssertionError(f"streamed run of {runner.trials} trials gathered {runner.batches} "
                             f"batches ({steps} wanted) and moved {runner.h2d_bytes} bytes, "
                             f"want {epochs} x {images.nbytes}")
    # the preloaded twin of each trial, handed the streamed orders
    fit_eval = task._fit_eval_fn(n_train, epochs, n_val)
    orders = [epoch_order(n_train, STREAM_SEED * 1000 + e) for e in range(epochs)]
    dev_images, dev_labels = task.prepack(images), task._labels(labels)
    dev_val = task.prepack(val)
    gaps = []
    for t, (lr, wd) in enumerate(hparams):
        trainable, frozen, state = task._init_trial(STREAM_SEED, t)
        _, logits = fit_eval(combine(trainable, frozen), dev_images, dev_labels, dev_val, state,
                             [lr] * epochs, wd, orders=orders)
        for e in range(epochs):
            want = logits[e].cpu().numpy()
            got = seen[e * len(hparams) + t]
            gap, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
            if got.shape != want.shape or not gap <= 1e-5 * scale:
                raise AssertionError(f"trial {t} epoch {e}: streamed vs preloaded val logits "
                                     f"{gap} > 1e-5 * {scale}")
            gaps.append({"trial": t, "epoch": e, "max_abs_gap": gap, "max_abs_logit": scale})
    if not all(np.isfinite(r["best_logits"]).all() for r in res):
        raise AssertionError("non-finite streamed run")
    return ({"train_images": n_train, "val_images": n_val, "trials": len(hparams),
             "epochs": epochs, "launches": launches, "h2d_bytes": runner.h2d_bytes,
             "split_bytes": images.nbytes, "batches_gathered": runner.batches,
             "logit_gaps": gaps, "best_scores": [r["best_score"] for r in res],
             "seconds": seconds}, batches)


def device_busy_ms(fn) -> tuple:
    """(wall ms, device-busy ms) of ``fn`` under a CUDA-only profiler trace:
    the union of the card's kernel and copy intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the raw events: an epoch holds ~10^5 kernels, too many to parse into
    # the profiler's function events in the time limit
    return wall, busy_ms([e for e in prof.profiler.kineto_results.events()
                          if e.device_type() == DeviceType.CUDA])


def busy_ms(events) -> float:
    """The union of the device events' intervals, in ms."""
    spans = sorted((e.start_ns(), e.end_ns()) for e in events)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    total, (lo, hi) = 0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            total, lo, hi = total + hi - lo, s, e
        else:
            hi = max(hi, e)
    return (total + hi - lo) / 1e6


def stream_full(kernels, clip, prototypes, rng, card: str) -> tuple:
    """11b: a 4.21 GB bf16 split streams by the default rule: epochs of one
    trial (after a warm-up) on a seeded ViT-B/32 tower of STREAM_FULL_LAYERS
    blocks beside the preloaded path on the same split held on the card,
    a streamed and a preloaded epoch, then a preloaded and a streamed one
    under a CUDA-only profile (each side's rate the mean of its two, and
    the plain epochs' ratio apart); exact launches, the split's bytes once
    and the card's peak allocation in the first; each side's device idle
    share from its profiled epoch."""
    from pevit_tpu_torch.core import CLIPSpec, init_clip_params

    block, block_labels = noisy_split(prototypes, 1000, rng)
    reps = STREAM_FULL // len(block)
    images, labels = np.tile(block, (reps, 1, 1, 1)), np.tile(block_labels, reps)
    val, val_labels = noisy_split(prototypes, STREAM_VAL, rng)
    full = CLIPSpec.vit_b32()
    spec = dataclasses.replace(full, vision=dataclasses.replace(full.vision,
                                                                layers=STREAM_FULL_LAYERS))
    tower = init_clip_params(torch.Generator().manual_seed(STREAM_SEED), spec, device="cuda")
    task = make_task(tower, "bfloat16", 0.5, spec=spec)
    hp = [(TRAIN_LR, TRAIN_WD)]
    limit = float(task.config.TPU.MAX_DEVICE_DATA_GB)
    if limit != 4.0 or images.nbytes <= limit * 1e9:
        raise AssertionError(f"{images.nbytes} bytes against a {limit} GB limit: not streamed")
    # warm-up: a 10-step streamed epoch
    set_device_limit(task, 1e-3)
    task.train_trials(hp, images[:10 * TRAIN_BATCH], labels[:10 * TRAIN_BATCH], val,
                      val_labels, end_epoch=1)
    set_device_limit(task, limit)
    torch.cuda.synchronize()

    def streamed():
        return task.train_trials(hp, images, labels, val, val_labels, end_epoch=1)

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with spied_runners() as runners:
        reset_launches(kernels)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s_seconds = [timed(streamed)]
        launches = read_launches(kernels)
        peak = torch.cuda.max_memory_allocated() - base
    (runner,) = runners
    batches = stream_batches(STREAM_FULL, STREAM_VAL, TRAIN_BATCH, task.eval_chunk, 1,
                             "bfloat16", layers=STREAM_FULL_LAYERS)  # one trial, one epoch
    if launches != expected_launches(batches):
        raise AssertionError(f"streamed epoch launches {launches}, want "
                             f"{expected_launches(batches)}")
    if runner.h2d_bytes != images.nbytes or peak >= images.nbytes:
        raise AssertionError(f"streamed epoch moved {runner.h2d_bytes} of {images.nbytes} bytes, "
                             f"peak card allocation {peak}")
    loss = task.last_state.loss.item()
    if not np.isfinite(loss):
        raise AssertionError("non-finite streamed epoch")

    t0 = time.perf_counter()
    dev_images, dev_labels = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0

    def preloaded():
        return task.train_trials(hp, dev_images, dev_labels, val, val_labels, end_epoch=1)

    # streamed, preloaded, then preloaded and streamed under a CUDA-only
    # profile, which gives each side's idle share: a host-bound epoch's
    # time moves by up to a quarter between runs, so each side's mean of
    # its plain and its profiled epoch is compared (both sides pay the
    # profiler alike; the plain epochs' ratio is kept beside it).  Two
    # further plain epochs would cost ~45 s of the script's time limit
    p_seconds = [timed(preloaded)]
    p_wall, p_busy = device_busy_ms(preloaded)
    s_wall, s_busy = device_busy_ms(streamed)
    p_seconds.append(p_wall / 1e3)
    s_seconds.append(s_wall / 1e3)
    del dev_images, dev_labels
    s_mean, p_mean = float(np.mean(s_seconds)), float(np.mean(p_seconds))
    out = {"images": STREAM_FULL, "layers": STREAM_FULL_LAYERS,
           "split_gb": images.nbytes / 1e9, "limit_gb": limit,
           "launches": launches, "h2d_bytes": runner.h2d_bytes, "peak_card_bytes": peak,
           "streamed_images_per_s": STREAM_FULL / s_mean,
           "preloaded_images_per_s": STREAM_FULL / p_mean,
           "streamed_over_preloaded": p_mean / s_mean,
           "plain_streamed_over_preloaded": p_seconds[0] / s_seconds[0],
           "streamed_seconds": s_seconds, "preloaded_seconds": p_seconds,
           "split_to_card_s": h2d_s, "last_loss": loss,
           "profiled": {"streamed": {"wall_ms": s_wall, "device_busy_ms": s_busy,
                                     "device_idle_share": 1 - s_busy / s_wall},
                        "preloaded": {"wall_ms": p_wall, "device_busy_ms": p_busy,
                                      "device_idle_share": 1 - p_busy / p_wall}}}
    return out, batches


def stream_command(kernels, tmp: Path) -> tuple:
    """11c: ``kronecker_adaptation_clip`` with phase 6's flags and
    ``--no-tuning True``, the train split (and the test split) in host
    memory and the val split on the card: the final run merges them on the
    host and streams; the artifacts' schema and exact launches."""
    from pevit_tpu_torch.commands import kronecker_adaptation_clip
    from pevit_tpu_torch.train import TrainTask

    # 40 train images (6.0 MB) and 160 test images stay on the host, the
    # 10 val images (1.5 MB) go to the card
    argv = command_argv(tmp, "True", "0.001", "0.0001") + ["TPU.MAX_DEVICE_DATA_GB", "0.003"]
    kinds, train_trials = [], TrainTask.train_trials

    def spy(self, hp, tx, ty, vx, vy, **kw):
        kinds.append((type(tx).__name__, type(vx).__name__))
        return train_trials(self, hp, tx, ty, vx, vy, **kw)

    times = {}
    TrainTask.train_trials = spy
    try:
        with spied_runners() as runners:
            reset_launches(kernels)
            t0 = time.perf_counter()
            with timed_command(times):
                best, info = kronecker_adaptation_clip.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_launches(kernels)
    finally:
        TrainTask.train_trials = train_trials
    (task, data, config), _ = times["run_method_call"]
    host = [isinstance(d, np.ndarray) for d in data]
    if host != [True, True, False, False, True, True] or kinds != [("ndarray", "ndarray")]:
        raise AssertionError(f"splits on the host {host}; the final run was handed {kinds}")
    check_command_artifacts(tmp)
    batches = path_batches(task, times["calls"])
    if launches != expected_launches(batches) or len(runners) != 1:
        raise AssertionError(f"streamed command launches {launches}, want "
                             f"{expected_launches(batches)}; runners {len(runners)}")
    close_command_logs()
    epochs = config.TRAIN.END_EPOCH + config.TRAIN.EXTRA_FINAL_TRAIN_EPOCH
    return ({"best_acc": best, "n_trainable_params": info["n_trainable_params"],
             "final_run_handed": kinds[0], "launches": launches, "epochs": epochs,
             "h2d_bytes": runners[0].h2d_bytes, "train_step_images": dict(batches["train"]),
             "eval_chunk_images": dict(batches["evals"]),
             "seconds": {"command": seconds, "run_method": times["run_method"]}}, batches)


def run_streaming(kernels, gen, card: str, clip, prototypes) -> tuple:
    """Phase 11; returns the launches and kernel rows of its paths."""
    launches, table = {}, {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}
    rng = np.random.default_rng(STREAM_SEED)
    t_phase, steps, paths = time.perf_counter(), {}, {}
    t0 = time.perf_counter()
    out, paths["stream_right"] = stream_right(kernels, clip, prototypes, rng)
    print(f"stream right: {json.dumps(out)} [{card}]", flush=True)
    steps["right"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, paths["stream_full"] = stream_full(kernels, clip, prototypes, rng, card)
    print(f"stream full size: {json.dumps(out)} [{card}]", flush=True)
    steps["full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        out, paths["stream_command"] = stream_command(kernels, Path(tmp))
    print(f"stream command kronecker_adaptation_clip: {json.dumps(out)} [{card}]", flush=True)
    steps["command"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for path, batches in paths.items():
        launches[path] = expected_launches(batches)
        for name, rows_ in path_kernel_rows(gen, path, batches).items():
            table[name].extend(rows_)
            for r in rows_:
                print(f"{path} kernel {name} {json.dumps(r)} [{card}]", flush=True)
    steps["kernel_rows"] = time.perf_counter() - t0
    print(f"phase 11 seconds by step: {json.dumps(steps)}", flush=True)
    return launches, table, time.perf_counter() - t_phase


# ---------------------------------------------------------------------------
# 12. trial batches: a sweep chunk's trials trained as one batch
# ---------------------------------------------------------------------------

TRIAL_SEED = 7
TRIAL_VAL = 160  # phase 5's val split cut to chunks of 64, 64 and 32
# (a) four trials of distinct (lr, wd), fp32, dropout 0
TRIAL_RIGHT = [(1e-3, 1e-4), (3e-4, 1e-2), (2e-3, 0.0), (5e-4, 1e-3)]
# (b) a chunk of TPU.SWEEP_PARALLEL_TRIALS = 8 (its default), bf16, dropout 0.5
TRIAL_WIDTH = 8
TRIAL_FULL = [(lr, wd) for lr in (1e-3, 3e-4) for wd in (0.0, 1e-4, 1e-3, 1e-2)]
# (c) the cap below a chunk of 8's need, as a share of it above the base
OOM_CAP_SHARE = 0.75


def trial_logits(task, seen: list):
    """Spy on ``task._fit_eval_fn``: each fit_eval call's (trained params,
    val logits) into ``seen``, copied to the host."""
    build = task._fit_eval_fn

    def wrapped(*a, **k):
        fit_eval = build(*a, **k)

        def run(*args, **kw):
            state, logits = fit_eval(*args, **kw)
            seen.append(({n: p.detach().float().cpu() for n, p in state.params.items()},
                         logits.cpu().numpy()))
            return state, logits
        return run

    task._fit_eval_fn = wrapped


def per_trial(seen: list, batched: bool, trials: int) -> list:
    """[(val logits (epochs, n, K), {name: params})] per trial from
    ``trial_logits``: the batched path's one call, or the serial path's one
    call per trial."""
    if not batched:
        return [(logits, params) for params, logits in seen]
    ((params, logits),) = seen
    return [(logits[t], {n: p[t] for n, p in params.items()}) for t in range(trials)]


def trial_gaps(got: list, want: list, what: str, limit=None) -> list:
    """Per trial: the largest val-logit and trained-parameter gaps, each
    relative to the serial path's largest value; held to ``limit`` where
    one is given."""
    gaps = []
    for t, ((g_logits, g_params), (w_logits, w_params)) in enumerate(zip(got, want)):
        rel = lambda g, w: float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        leaf_gap, leaf = max((rel(g_params[n].numpy(), w_params[n].numpy()), n)
                             for n in w_params if w_params[n].abs().max() > 0)
        row = {"trial": t, "logit_gap": rel(g_logits, w_logits), "param_gap": leaf_gap,
               "param_gap_leaf": leaf}
        if limit is not None and max(row["logit_gap"], row["param_gap"]) > limit:
            raise AssertionError(f"{what} trial {t}: batched vs serial {row} > {limit}")
        gaps.append(row)
    return gaps


def trial_run(task, hparams, data, *, serial: bool, epochs: int = TRAIN_EPOCHS):
    """One chunk of ``hparams`` through ``train_trials`` (or the serial
    path), seconds and per-trial (logits, params)."""
    images, labels, val, val_labels = data
    seen = []
    trial_logits(task, seen)
    train = task._train_trials_serial if serial else task.train_trials
    t0 = time.perf_counter()
    res = train(hparams, images, labels, val, val_labels, end_epoch=epochs, seed=TRIAL_SEED,
                keep_logits=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del task._fit_eval_fn
    return seconds, res, per_trial(seen, not serial, len(hparams))


def trial_launches(kernels, task, hparams, data, batches_of=path_batches) -> tuple:
    """The batched chunk with its launches read around it and held to one
    launch a block a step and eval chunk for the whole chunk (the batches
    ``batches_of(task, calls)`` gives).  Returns (seconds, results,
    per-trial outputs, launches, batches)."""
    calls = []
    reset_launches(kernels)
    with recorded_calls(calls):
        seconds, res, out = trial_run(task, hparams, data, serial=False)
    launches = read_launches(kernels)
    batches = batches_of(task, calls)
    want = expected_launches(batches)
    steps = sum(batches["train"].values())
    if launches != want or calls[0]["trials"] != len(hparams):
        raise AssertionError(f"chunk of {len(hparams)}: launches {launches}, want {want} "
                             f"({steps} steps and {sum(batches['evals'].values())} eval "
                             f"chunks for the whole chunk); calls {calls}")
    return seconds, res, out, launches, batches


def trials_right(kernels, clip, data) -> tuple:
    """12a: four fp32 KAdaptation trials, dropout 0, batched and serial:
    every (trial, epoch) val logit and each trial's trained factors within
    1e-5 of the largest."""
    task = make_task(clip, "float32", 0.0)
    seconds, res, got, launches, batches = trial_launches(kernels, task, TRIAL_RIGHT, data)
    serial_s, serial_res, want = trial_run(task, TRIAL_RIGHT, data, serial=True)
    gaps = trial_gaps(got, want, "fp32", limit=1e-5)
    if not all(np.isfinite(r["best_logits"]).all() for r in res):
        raise AssertionError("non-finite batched fp32 run")
    return ({"trials": len(TRIAL_RIGHT), "epochs": TRAIN_EPOCHS, "launches": launches,
             "gaps": gaps, "best_scores": [r["best_score"] for r in res],
             "serial_best_scores": [r["best_score"] for r in serial_res],
             "seconds": {"batched": seconds, "serial": serial_s}}, batches)


def trials_full(kernels, clip, data) -> tuple:
    """12b: a chunk of 8 bf16 trials at batch 128, dropout 0.5, after a
    warm-up chunk: batched and serial in turns (S B B S), seconds per trial,
    each path's device idle share from a CUDA-only profile of one more run,
    the card's peak allocation of a batched chunk, exact launches; each
    trial's gap to the serial path and both best scores, reported."""
    task = make_task(clip, "bfloat16", 0.5)
    if task.max_parallel_trials() != TRIAL_WIDTH:
        raise AssertionError(f"TPU.SWEEP_PARALLEL_TRIALS {task.max_parallel_trials()}")
    hp = TRIAL_FULL
    trial_run(task, hp[:2], data, serial=False, epochs=1)  # warm-up
    s_seconds = [trial_run(task, hp, data, serial=True)[0]]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seconds, res, got, launches, batches = trial_launches(kernels, task, hp, data)
    peak = torch.cuda.max_memory_allocated() - base
    b_seconds = [seconds, trial_run(task, hp, data, serial=False)[0]]
    s_seconds_2, serial_res, want = trial_run(task, hp, data, serial=True)
    s_seconds.append(s_seconds_2)
    b_wall, b_busy = device_busy_ms(lambda: task.train_trials(
        hp, *data[:2], *data[2:], end_epoch=TRAIN_EPOCHS, seed=TRIAL_SEED))
    s_wall, s_busy = device_busy_ms(lambda: task._train_trials_serial(
        hp, *data[:2], *data[2:], end_epoch=TRAIN_EPOCHS, seed=TRIAL_SEED))
    if not all(np.isfinite(r["best_logits"]).all() for r in res):
        raise AssertionError("non-finite batched bf16 chunk")
    T = len(hp)
    b_mean, s_mean = float(np.mean(b_seconds)), float(np.mean(s_seconds))
    return ({"trials": T, "epochs": TRAIN_EPOCHS, "batch": TRAIN_BATCH, "launches": launches,
             "seconds_per_trial": {"batched": b_mean / T, "serial": s_mean / T},
             "serial_over_batched": s_mean / b_mean,
             "batched_seconds": b_seconds, "serial_seconds": s_seconds,
             "peak_card_bytes": peak,
             "profiled": {"batched": {"wall_ms": b_wall, "device_busy_ms": b_busy,
                                      "device_idle_share": 1 - b_busy / b_wall},
                          "serial": {"wall_ms": s_wall, "device_busy_ms": s_busy,
                                     "device_idle_share": 1 - s_busy / s_wall}},
             "gaps": trial_gaps(got, want, "bf16"),
             "best_scores": [r["best_score"] for r in res],
             "serial_best_scores": [r["best_score"] for r in serial_res]}, batches, peak)


def trials_oom(clip, data, peak: int) -> dict:
    """12c: the process capped below a chunk of 8's need (its peak from
    12b) and above a chunk of 4's; ``sweep._run_stage`` on 8 trials splits
    the chunk that runs out of memory, logs the split and returns 8 finite
    scores.  The cap is lifted afterwards."""
    from pevit_tpu_torch.train import sweep

    task = make_task(clip, "bfloat16", 0.5)
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = torch.cuda.memory_reserved() + OOM_CAP_SHARE * peak
    records, calls = [], []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    root = logging.getLogger()
    root.addHandler(handler)
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        with recorded_calls(calls):
            t0 = time.perf_counter()
            scores = sweep._run_stage(task, TRIAL_FULL, data, TRAIN_EPOCHS, TRIAL_SEED,
                                      TRIAL_WIDTH)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
        root.removeHandler(handler)
    split = [m for m in records if "ran out of card memory" in m]
    widths = [c["trials"] for c in calls]
    if (len(scores) != len(TRIAL_FULL) or not all(np.isfinite(scores)) or not split
            or widths[0] != TRIAL_WIDTH or sum(w for w in widths if w < TRIAL_WIDTH) < 8):
        raise AssertionError(f"capped sweep stage: scores {scores}, chunks {widths}, "
                             f"log {split}")
    return {"cap_bytes": cap, "cap_share_of_card": cap / total, "chunk_widths_run": widths,
            "split_log": split, "scores": scores, "seconds": seconds}


def run_trial_batches(kernels, gen, card: str, clip, data) -> tuple:
    """Phase 12; returns the launches and kernel rows of its batched paths."""
    launches, table = {}, {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}
    data = (*data[:2], data[2][:TRIAL_VAL], data[3][:TRIAL_VAL])
    t_phase, steps, paths = time.perf_counter(), {}, {}
    t0 = time.perf_counter()
    out, paths["trials_fp32"] = trials_right(kernels, clip, data)
    print(f"trial batch fp32: {json.dumps(out)} [{card}]", flush=True)
    steps["right"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, paths["trials_bf16"], peak = trials_full(kernels, clip, data)
    print(f"trial batch bf16: {json.dumps(out)} [{card}]", flush=True)
    steps["full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = trials_oom(clip, data, peak)
    print(f"trial batch out of memory: {json.dumps(out)} [{card}]", flush=True)
    steps["oom"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for path, batches in paths.items():
        launches[path] = expected_launches(batches)
        for name, rows_ in path_kernel_rows(gen, path, batches).items():
            table[name].extend(rows_)
            for r in rows_:
                print(f"{path} kernel {name} {json.dumps(r)} [{card}]", flush=True)
    steps["kernel_rows"] = time.perf_counter() - t0
    print(f"phase 12 seconds by step: {json.dumps(steps)}", flush=True)
    return launches, table, time.perf_counter() - t_phase


# ---------------------------------------------------------------------------
# 13. trial axis II: full fine-tuning and the auxiliary backbones as one batch
# ---------------------------------------------------------------------------

AXIS_BATCH = 32
# phase 5's data cut to 8 train steps an epoch; 13a evaluates phase 12's 160
# val images, 13b and 13c the first 64
AXIS_TRAIN, AXIS_VAL = 256, 64
# full fine-tuning at the finetune command's scale of rates, and the linear
# probe's, each with four weight decays: the chunk of 8, or 4 of them; the
# fp32 checks fine-tune at ten times the rates, so that two epochs move the
# val logits by far more than the tolerance
AXIS_FT = [(lr, wd) for lr in (1e-5, 3e-5) for wd in (0.0, 1e-4, 1e-3, 1e-2)]
AXIS_PROBE = [(lr, wd) for lr in (1e-2, 3e-3) for wd in (0.0, 1e-4, 1e-3, 1e-2)]
AXIS_RIGHT = [(10 * lr, wd) for lr, wd in AXIS_FT[::2]]
AXIS_DROP_PATH = 0.1
# N(0, LIVE_BIAS) added to every bias of a tower that the fp32 checks
# fine-tune, as a pretrained tower's are live: a bias trained from zero holds
# lr times its summed gradient, and the last blocks' sum over a batch nearly
# cancels (the shift that ln_post and the head's BN take out), so float32
# summation order alone moves it by 2.5e-5 of itself at any rate (13a's
# ViT-B/32 on an H100 80GB HBM3, at lr 1e-5 and 1e-4 alike)
LIVE_BIAS = 0.02


def live_biases(module, seed: int):
    """``module`` with N(0, LIVE_BIAS) added to every bias, in place."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rsplit(".", 1)[-1] == "bias":
                p.add_((torch.randn(p.shape, generator=gen) * LIVE_BIAS).to(p.device))
    return module


def axis_task(method: str, dtype_name: str, *, clip=None, backbone=None):
    """A task of ``method`` at batch AXIS_BATCH, 100 classes, through the
    config entry points: on the CLIP ViT-B/32 tower ``clip``, or on an
    auxiliary ``backbone`` (which runs in float32 whatever the dtype)."""
    from pevit_tpu_torch.config import get_default_config
    from pevit_tpu_torch.core import CLIPSpec
    from pevit_tpu_torch.peft import PeftConfig
    from pevit_tpu_torch.train import TaskStatic, TrainTask

    cfg = get_default_config()
    cfg.defrost()
    cfg.DATASET.NUM_CLASSES = 100
    cfg.TRAIN.BATCH_SIZE_PER_GPU = AXIS_BATCH
    cfg.TPU.COMPUTE_DTYPE = dtype_name
    cfg.freeze()
    static = TaskStatic.from_config(cfg, CLIPSpec.vit_b32(), PeftConfig(method=method),
                                    feat_dim=0 if backbone is None else backbone.feat_dim)
    return TrainTask(cfg, static, clip, device="cuda", backbone=backbone)


def axis_right(kernels, task, hparams, data, what: str, batches_of=path_batches) -> tuple:
    """A float32 chunk batched (its launches held to one a block a step and
    eval chunk for the whole chunk) and serial: every (trial, epoch) val
    logit and each trial's trained parameters within 1e-5 of the serial
    path's largest, the second epoch's logits moved by more than 100x that
    from the first's, seconds a trial of each.  Returns (summary, batches)."""
    seconds, res, got, launches, batches = trial_launches(kernels, task, hparams, data,
                                                          batches_of)
    serial_s, serial_res, want = trial_run(task, hparams, data, serial=True)
    gaps = trial_gaps(got, want, what, limit=1e-5)
    moved = min(float(np.abs(w[1] - w[0]).max() / np.abs(w).max()) for w, _ in want)
    if moved <= 100 * 1e-5:
        raise AssertionError(f"{what}: the second epoch moved the val logits by {moved}")
    if not all(np.isfinite(r["best_logits"]).all() for r in res):
        raise AssertionError(f"non-finite batched {what} run")
    T = len(hparams)
    return ({"trials": T, "epochs": TRAIN_EPOCHS, "batch": task.static.batch_size,
             "launches": launches, "gaps": gaps, "logits_moved": moved,
             "train_step_images": dict(batches["train"]),
             "eval_chunk_images": dict(batches["evals"]),
             "seconds_per_trial": {"batched": seconds / T, "serial": serial_s / T},
             "best_scores": [r["best_score"] for r in res],
             "serial_best_scores": [r["best_score"] for r in serial_res]}, batches)


def axis_clip(kernels, clip, data) -> tuple:
    """13a: full fine-tuning of phase 4's ViT-B/32 tower.  A bf16 chunk of 8
    after a warm-up chunk, serial, batched, batched, serial: seconds a trial
    of each path (the mean of its two runs), each one's device idle share
    from a CUDA-only profile of one more run, the card's peak allocation of a
    batched chunk, K1 exactly 12 a step and an eval chunk for the whole
    chunk (K2 and K3 off: the MLP weights train); then an fp32 chunk of 4
    on a copy of the tower with live biases (``live_biases``), batched and
    serial within 1e-5.  The pretrained tower is left as it was: every
    trial trains its own slice of the stack."""
    sums = torch.stack([p.detach().float().sum() for p in clip.parameters()])
    task = axis_task("full_finetune", "bfloat16", clip=clip)
    hp = AXIS_FT
    trial_run(task, hp[:2], data, serial=False, epochs=1)  # warm-up
    s_seconds = [trial_run(task, hp, data, serial=True)[0]]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seconds, res, _, launches, bf16_batches = trial_launches(kernels, task, hp, data)
    peak = torch.cuda.max_memory_allocated() - base
    b_seconds = [seconds, trial_run(task, hp, data, serial=False)[0]]
    s_seconds.append(trial_run(task, hp, data, serial=True)[0])
    b_wall, b_busy = device_busy_ms(lambda: task.train_trials(
        hp, *data[:2], *data[2:], end_epoch=TRAIN_EPOCHS, seed=TRIAL_SEED))
    s_wall, s_busy = device_busy_ms(lambda: task._train_trials_serial(
        hp, *data[:2], *data[2:], end_epoch=TRAIN_EPOCHS, seed=TRIAL_SEED))
    if not all(np.isfinite(r["best_logits"]).all() for r in res):
        raise AssertionError("non-finite batched bf16 full fine-tuning chunk")
    T = len(hp)
    b_mean, s_mean = float(np.mean(b_seconds)), float(np.mean(s_seconds))
    bf16 = {"trials": T, "epochs": TRAIN_EPOCHS, "batch": AXIS_BATCH, "launches": launches,
            "train_step_images": dict(bf16_batches["train"]),
            "eval_chunk_images": dict(bf16_batches["evals"]),
            "seconds_per_trial": {"batched": b_mean / T, "serial": s_mean / T},
            "serial_over_batched": s_mean / b_mean,
            "batched_seconds": b_seconds, "serial_seconds": s_seconds,
            "peak_card_bytes": peak,
            "profiled": {"batched": {"wall_ms": b_wall, "device_busy_ms": b_busy,
                                     "device_idle_share": 1 - b_busy / b_wall},
                         "serial": {"wall_ms": s_wall, "device_busy_ms": s_busy,
                                    "device_idle_share": 1 - s_busy / s_wall}},
            "best_scores": [r["best_score"] for r in res]}
    del task
    torch.cuda.empty_cache()
    live = live_biases(copy.deepcopy(clip), TRIAL_SEED)
    fp32, fp32_batches = axis_right(kernels, axis_task("full_finetune", "float32", clip=live),
                                    AXIS_RIGHT, data, "ViT-B/32 full_finetune fp32")
    del live
    if not torch.equal(sums, torch.stack([p.detach().float().sum() for p in clip.parameters()])):
        raise AssertionError("full fine-tuning changed the task's pretrained tower")
    return {"bf16": bf16, "fp32": fp32}, {"axis_clip_ft_bf16": bf16_batches,
                                          "axis_clip_ft_fp32": fp32_batches}


def axis_backbones(kernels, data) -> tuple:
    """13b: the timm ViT-B/16 (live biases) under fp32 full fine-tuning, a
    chunk of 4 (K1's fp32 body at 4 x 32 images, N = 197, 12 a step), and the DeCLIP
    ViT-B/32 linear probe, a chunk of 8 on the shared frozen tower (K1 and
    K2 fp32, 12 each a step and an eval chunk): each batched and serial
    within 1e-5."""
    from pevit_tpu_torch.models import get_model

    out, paths = {}, {}
    vit = get_model(aux_config("vit_base_patch16_224.yaml"), device="cuda")
    live_biases(vit.params, TRIAL_SEED)
    out["vit_b16_full_finetune"], paths["axis_vit_ft"] = axis_right(
        kernels, axis_task("full_finetune", "float32", backbone=vit), AXIS_RIGHT, data,
        "ViT-B/16 full_finetune", lambda t, calls: aux_batches(t, calls, 197, fused_mlp=False))
    del vit
    torch.cuda.empty_cache()
    declip = get_model(aux_config("vitb32_DeCLIP.yaml"), device="cuda")
    out["declip_linear_probe"], paths["axis_declip_probe"] = axis_right(
        kernels, axis_task("linear_probe", "float32", backbone=declip), AXIS_PROBE, data,
        "DeCLIP linear_probe", lambda t, calls: aux_batches(t, calls, 50, fused_mlp=True))
    return out, paths


def axis_swin(kernels, data, tmp: Path) -> tuple:
    """13c: Swin-T (live biases) with DROP_PATH_RATE 0.1, the linear probe and
    full fine-tuning, chunks of 4, fp32: every train step through the stochastic
    forward, each trial's drop-path draws from its own generators, batched
    and serial within 1e-5.  The plain path: no kernel launches."""
    from pevit_tpu_torch.models import get_model

    yaml = tmp / "cls_swin_tiny_axis.yaml"
    yaml.write_text(f"MODEL:\n  NAME: cls_swin_tiny\n  SPEC:\n    DROP_PATH_RATE: "
                    f"{AXIS_DROP_PATH}\n")
    no_kernel = lambda t, calls: aux_batches(t, calls, 0, fused_mlp=False, layers=0)
    out, paths = {}, {}
    for method, hp in (("linear_probe", AXIS_PROBE[::2]), ("full_finetune", AXIS_RIGHT)):
        swin = get_model(aux_config(str(yaml)), device="cuda")
        live_biases(swin.params, TRIAL_SEED)
        if swin.forward_features_train is None:
            raise AssertionError("cls_swin_tiny with drop path has no train-mode forward")
        with stochastic_forwards() as calls:
            out[f"swin_{method}"], paths[f"axis_swin_{method}"] = axis_right(
                kernels, axis_task(method, "float32", backbone=swin), hp, data,
                f"Swin-T {method}", no_kernel)
        steps = sum(paths[f"axis_swin_{method}"]["train"].values())
        # the batched chunk's steps, then each serial trial's
        if len(calls) != steps * (1 + len(hp)) or not all(calls):
            raise AssertionError(f"Swin-T {method}: {len(calls)} stochastic forwards for "
                                 f"{steps} steps batched and {len(hp)} x {steps} serial")
        out[f"swin_{method}"]["stochastic_train_forwards"] = len(calls)
        del swin
        torch.cuda.empty_cache()
    return out, paths


def run_trial_axis(kernels, gen, card: str, clip, data) -> tuple:
    """Phase 13; returns the launches and kernel rows of its batched paths."""
    launches, table = {}, {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}
    clip_data = (*data[0:2], data[2][:TRIAL_VAL], data[3][:TRIAL_VAL])
    clip_data = (clip_data[0][:AXIS_TRAIN], clip_data[1][:AXIS_TRAIN], *clip_data[2:])
    small = (*clip_data[:2], clip_data[2][:AXIS_VAL], clip_data[3][:AXIS_VAL])
    t_phase, steps, paths = time.perf_counter(), {}, {}
    t0 = time.perf_counter()
    out, found = axis_clip(kernels, clip, clip_data)
    paths.update(found)
    print(f"trial axis ViT-B/32 full_finetune: {json.dumps(out)} [{card}]", flush=True)
    steps["clip"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, found = axis_backbones(kernels, small)
    paths.update(found)
    print(f"trial axis backbones: {json.dumps(out)} [{card}]", flush=True)
    steps["backbones"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_axis_") as tmp:
        out, found = axis_swin(kernels, small, Path(tmp))
    paths.update(found)
    print(f"trial axis Swin-T: {json.dumps(out)} [{card}]", flush=True)
    steps["swin"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for path, batches in paths.items():
        launches[path] = expected_launches(batches)
        if not batches["layers"]:
            continue
        for name, rows_ in path_kernel_rows(gen, path, batches).items():
            table[name].extend(rows_)
            for r in rows_:
                print(f"{path} kernel {name} {json.dumps(r)} [{card}]", flush=True)
    steps["kernel_rows"] = time.perf_counter() - t0
    print(f"phase 13 seconds by step: {json.dumps(steps)}", flush=True)
    return launches, table, time.perf_counter() - t_phase


# ---------------------------------------------------------------------------
# 14. the mesh: a world of one over NCCL, and a 2-rank gloo world on the card
# ---------------------------------------------------------------------------

MESH_SEED = 9
MESH_TRIALS = [(lr, wd) for lr in (1e-3, 3e-4) for wd in (0.0, 1e-4, 1e-3, 1e-2)]
MESH_TRIAL_SPLIT = (64, 64, 32)  # train, val, batch: 2 steps and one eval chunk, 1 epoch
MESH_FINAL_SPLIT = (300, 100)  # 2 full steps of 128 and a natural tail of 44; 64 + 36
MESH_TP_SPLIT = (128, 64)  # one step of 128, one eval chunk
MESH_SERVE_BATCH = 256
MESH_LR, MESH_WD = 1e-3, 1e-4


def mesh_split(prototypes, n_train: int, n_val: int, seed: int) -> tuple:
    """Noisy prototypes, seeded: every rank draws the same split."""
    rng = np.random.default_rng(seed)

    def noisy(labels):
        noise = rng.integers(-8, 9, (len(labels),) + prototypes.shape[1:], dtype=np.int16)
        return np.clip(prototypes[labels].astype(np.int16) + noise, 0, 255).astype(np.uint8)

    ty = rng.integers(0, len(prototypes), n_train)
    vy = rng.integers(0, len(prototypes), n_val)
    return noisy(ty), ty, noisy(vy), vy


def mesh_runs(prototypes) -> dict:
    """The runs of phase 14b, each with its task's options and split."""
    trial = mesh_split(prototypes, *MESH_TRIAL_SPLIT[:2], MESH_SEED)
    final = mesh_split(prototypes, *MESH_FINAL_SPLIT, MESH_SEED + 1)
    tp = mesh_split(prototypes, *MESH_TP_SPLIT, MESH_SEED + 2)
    return {
        "trials_fp32": (dict(dtype_name="float32", dropout_p=0.0, batch=MESH_TRIAL_SPLIT[2]),
                        MESH_TRIALS, trial),
        "trials_bf16": (dict(dtype_name="bfloat16", dropout_p=0.5, batch=MESH_TRIAL_SPLIT[2]),
                        MESH_TRIALS, trial),
        "final_data": (dict(dtype_name="float32", dropout_p=0.5), [(MESH_LR, MESH_WD)], final),
        "lora_model": (dict(dtype_name="float32", dropout_p=0.0, method="lora",
                            tpu={"MESH_MODEL": 2, "MESH_DATA": 1}), [(MESH_LR, MESH_WD)], tp),
    }


def mesh_run(clip, opts: dict, hparams: list, data) -> tuple:
    """One ``train_trials`` call, 1 epoch; (results, per-trial (logits,
    params) of this process's trials)."""
    task = make_task(clip, **opts)
    seen = []
    trial_logits(task, seen)
    res = task.train_trials(hparams, *data, end_epoch=1, seed=TRIAL_SEED, keep_logits=True)
    torch.cuda.synchronize()
    ((params, logits),) = seen
    return task, res, [(logits[t], {n: p[t] for n, p in params.items()})
                       for t in range(logits.shape[0])]


def mesh_batches(task, name: str, ranks: int) -> dict:
    """The batches one rank gave the kernels in run ``name`` of phase 14b,
    counted for ``ranks`` ranks (each gives the same): a trial rank's 4
    trials at their folded batch; a data rank's 64 rows of each full step
    and 32 of the full eval chunk, the natural tail (44) and remainder (36)
    whole; a model rank's 6 heads (K2 and K3 on the gathered weights)."""
    st = task.static
    batches = path_batches(task, [])
    B = st.batch_size
    train, evals = collections.Counter(), collections.Counter()
    if name.startswith("trials"):
        n_train, n_val, _ = MESH_TRIAL_SPLIT
        local = len(MESH_TRIALS) // 2
        train[local * B] += n_train // B
        evals[local * n_val] += 1
    elif name == "final_data":
        n_train, n_val = MESH_FINAL_SPLIT
        train[B // 2] += n_train // B
        train[n_train % B] += 1
        evals[task.eval_chunk // 2] += n_val // task.eval_chunk
        evals[n_val % task.eval_chunk] += 1
    else:
        n_train, n_val = MESH_TP_SPLIT
        train[B] += n_train // B
        evals[n_val] += 1
        batches["heads"] = st.spec.vision.heads // 2
    batches["train"] = collections.Counter({b: ranks * n for b, n in train.items()})
    batches["evals"] = collections.Counter({b: ranks * n for b, n in evals.items()})
    return batches


def mesh_gaps(got: list, want: list) -> tuple:
    """The largest val-logit and trained-parameter gaps over the trials,
    each relative to the single-process run's largest value."""
    rel = lambda g, w: float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    logit = max(rel(g[0], w[0]) for g, w in zip(got, want))
    param = max(rel(g[1][n].numpy(), w[1][n].numpy()) for g, w in zip(got, want)
                for n in w[1] if w[1][n].abs().max() > 0)
    return logit, param


def mesh_rank_main(out_dir: str) -> int:
    """A rank of phase 14b's 2-rank gloo world on the one card (this script
    run with ``--mesh-rank``, the launcher's variables set): every run of
    ``mesh_runs`` through the mesh and a data-parallel serving call from a
    mesh artifact, each rank's launches read around each, its outputs
    written for the parent."""
    import pickle

    from pevit_tpu_torch.ops import KERNELS
    from pevit_tpu_torch.serve import export_classifier, exported_callable, make_serving_fn
    from pevit_tpu_torch.utils import dist

    dist.initialize(backend="gloo", device="cuda:0")
    rank = dist.rank()
    static, trainable, frozen, bn, preproc = build_classifier(seed=0)
    res = static.spec.vision.input_resolution
    prototypes = np.random.default_rng(0).integers(0, 256, (static.num_classes, res, res, 3),
                                                   dtype=np.uint8)
    out = {"rank": rank, "runs": {}}
    for name, (opts, hparams, data) in mesh_runs(prototypes).items():
        reset_launches(KERNELS)
        t0 = time.perf_counter()
        task, results, trials = mesh_run(frozen["clip"], opts, hparams, data)
        seconds = time.perf_counter() - t0
        launches = read_launches(KERNELS)
        want = expected_launches(mesh_batches(task, name, 1))
        print(f"rank {rank} {name}: launches {launches} in {seconds:.2f} s", flush=True)
        if launches != want:
            raise AssertionError(f"rank {rank} {name}: launches {launches}, want {want}")
        out["runs"][name] = {"launches": launches, "seconds": seconds,
                             "plan": task._mesh_plan(len(hparams))[1:],
                             "scores": [r["best_score"] for r in results],
                             "trials": [(lg, {n: p.cpu() for n, p in ps.items()})
                                        for lg, ps in trials],
                             "first": 4 * rank if name.startswith("trials") else 0}
    # serving: the fitted classifier as a data-parallel artifact of width 2
    fit_prototype_head(static, trainable, frozen, bn, preproc, prototypes)
    images = mesh_split(prototypes, MESH_SERVE_BATCH, 0, MESH_SEED + 3)[0]
    serve = make_serving_fn(static, trainable, frozen, bn, preproc, device="cuda")
    want = serve(images).float().cpu()
    t0 = time.perf_counter()
    ep = export_classifier(static, trainable, frozen, bn, preproc, image_size=res,
                           device="cuda", mesh=2)
    export_s = time.perf_counter() - t0
    call = exported_callable(ep, device="cuda")
    call(images)  # warm-up
    reset_launches(KERNELS)
    got = call(images).float().cpu()
    torch.cuda.synchronize()
    launches = read_launches(KERNELS)
    print(f"rank {rank} serve: launches {launches}, export {export_s:.1f} s", flush=True)
    layers = static.spec.vision.layers
    if launches != {"attention_fwd": layers, "fused_mlp_fwd": layers, "fused_mlp_bwd": 0}:
        raise AssertionError(f"rank {rank} mesh serving launches {launches}")
    out["serve"] = {"launches": launches, "export_s": export_s,
                    "max_abs_diff": float((got - want).abs().max()),
                    "max_logit": float(want.abs().max()),
                    "top1": float((got.argmax(-1) == want.argmax(-1)).float().mean())}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def launcher_env(world: int, rank: int, port: int):
    """The launcher's variables of one rank, as torchrun sets them."""
    import os

    keys = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_world_one(kernels, clip, prototypes) -> tuple:
    """14a: a world of one over NCCL (the launcher's variables, this
    process): one ``all_reduce`` on the card, then a bf16 KAdaptation chunk
    through ``train_trials`` and its mesh plan, bit for bit the same chunk
    run before joining."""
    from pevit_tpu_torch.utils import dist

    opts, hparams, data = mesh_runs(prototypes)["trials_bf16"]
    _, before_res, before = mesh_run(clip, opts, hparams[:2], data)
    with launcher_env(1, 0, free_port()):
        dist.initialize()
        try:
            backend = torch.distributed.get_backend()
            t = torch.arange(4.0, device="cuda")
            torch.distributed.all_reduce(t)
            torch.cuda.synchronize()
            if backend != "nccl" or not torch.equal(t, torch.arange(4.0, device="cuda")):
                raise AssertionError(f"world of one: backend {backend}, all_reduce {t}")
            calls = []
            reset_launches(kernels)
            with recorded_calls(calls):
                task, after_res, after = mesh_run(clip, opts, hparams[:2], data)
            launches = read_launches(kernels)
            plan = task._mesh_plan(2)
        finally:
            torch.distributed.destroy_process_group()
    batches = path_batches(task, calls)
    if launches != expected_launches(batches) or plan[0] is not None:
        raise AssertionError(f"world of one: launches {launches}, plan {plan}")
    same = all(np.array_equal(a[0], b[0]) and all(torch.equal(a[1][n], b[1][n]) for n in a[1])
               for a, b in zip(before, after))
    if not same or [r["best_score"] for r in before_res] != [r["best_score"] for r in after_res]:
        raise AssertionError("world of one: the chunk is not the single-process chunk bit for bit")
    return {"backend": backend, "bit_equal": same, "launches": launches}, batches


def run_mesh(kernels, gen, card: str, clip, prototypes) -> tuple:
    """Phase 14; returns the launches and kernel rows of its paths."""
    import pickle

    t_phase, steps = time.perf_counter(), {}
    launches, table = {}, {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}
    paths = {}
    t0 = time.perf_counter()
    out, paths["mesh_world_one"] = mesh_world_one(kernels, clip, prototypes)
    launches["mesh_world_one"] = out["launches"]
    print(f"mesh world of one: {json.dumps(out)} [{card}]", flush=True)
    steps["world_one"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        port, procs = free_port(), []
        for rank in range(2):
            with launcher_env(2, rank, port):
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", tmp],
                    cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            for line in log.splitlines():
                if line.startswith(f"rank {rank} "):
                    print(line, flush=True)
            if p.returncode != 0:
                raise AssertionError(f"phase 14 rank {rank} failed:\n{log[-6000:]}")
        ranks = []
        for rank in range(2):
            with open(Path(tmp) / f"rank{rank}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    steps["world_two"] = time.perf_counter() - t0

    # the same runs in this process, without a world
    t0 = time.perf_counter()
    summary = {}
    for name, (opts, hparams, data) in mesh_runs(prototypes).items():
        t1 = time.perf_counter()
        task, res, want = mesh_run(clip, opts, hparams, data)
        single_s = time.perf_counter() - t1
        got = []
        for r in ranks:
            run = r["runs"][name]
            if run["scores"] != ranks[0]["runs"][name]["scores"]:
                raise AssertionError(f"{name}: the ranks' results differ")
            got.append((run["first"], run["trials"]))
        if name.startswith("trials"):
            got_trials = [t for _, trials in sorted(got, key=lambda x: x[0]) for t in trials]
        else:
            got_trials = got[0][1]
            for other in got[1][1]:  # every rank trained the same parameters
                if not all(torch.equal(other[1][n], got_trials[0][1][n]) for n in other[1]):
                    raise AssertionError(f"{name}: the ranks' parameters differ")
        logit_gap, param_gap = mesh_gaps(got_trials, want)
        held = opts["dtype_name"] == "float32"
        row = {"plan": ranks[0]["runs"][name]["plan"], "logit_gap": logit_gap,
               "param_gap": param_gap, "held": held,
               "scores": ranks[0]["runs"][name]["scores"],
               "single_scores": [x["best_score"] for x in res],
               "seconds": [r["runs"][name]["seconds"] for r in ranks],
               "single_seconds": single_s}
        if held and max(logit_gap, param_gap) > 1e-5:
            raise AssertionError(f"phase 14 {name}: mesh vs single process {row} > 1e-5")
        summary[name] = row
        paths[f"mesh_{name}"] = mesh_batches(task, name, 2)
        launches[f"mesh_{name}"] = {k: sum(r["runs"][name]["launches"][k] for r in ranks)
                                    for k in ranks[0]["runs"][name]["launches"]}
        print(f"mesh {name}: {json.dumps(row)} [{card}]", flush=True)
    serve = [r["serve"] for r in ranks]
    for s in serve:
        if s["top1"] < 1.0 or s["max_abs_diff"] > 1e-3 * s["max_logit"]:
            raise AssertionError(f"phase 14 mesh serving vs the serving fn: {s}")
    print(f"mesh serving, width 2, batch {MESH_SERVE_BATCH}: {json.dumps(serve)} [{card}]",
          flush=True)
    paths["mesh_serve"] = {**path_batches(task, []), "dtype": "bfloat16",
                           "train": collections.Counter(),
                           "evals": collections.Counter({MESH_SERVE_BATCH // 2: 2}),
                           "fused_mlp": True, "fused_mlp_bwd": False}
    launches["mesh_serve"] = {k: sum(s["launches"][k] for s in serve) for k in serve[0]["launches"]}
    steps["single_process"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for path, batches in paths.items():
        if launches[path] != expected_launches(batches):
            raise AssertionError(f"{path}: launches {launches[path]}, want "
                                 f"{expected_launches(batches)}")
        for name, rows_ in path_kernel_rows(gen, path, batches).items():
            table[name].extend(rows_)
            for r in rows_:
                print(f"{path} kernel {name} {json.dumps(r)} [{card}]", flush=True)
    steps["kernel_rows"] = time.perf_counter() - t0
    print(f"phase 14 seconds by step: {json.dumps(steps)}", flush=True)
    return launches, table, time.perf_counter() - t_phase


# ---------------------------------------------------------------------------
# the mesh across the cards of a host: ``python3 chip_smoke.py --mesh-cards``
# (not a phase of the default run, which needs one card)
# ---------------------------------------------------------------------------

CARDS_OPTS = ["TPU.PARITY_FP32", "True", "TRAIN.END_EPOCH", "2",
              "TRAIN.EXTRA_FINAL_TRAIN_EPOCH", "1"]


def cards_argv(out: Path, device: str) -> list:
    """Phase 6's command line in fp32 (TPU.PARITY_FP32), the sweep at 2
    epochs and the final run at 3, into ``out``; ``--device`` before the
    overrides unless the device is the card."""
    argv = command_argv(out)
    i = argv.index("DATASET.NUM_SAMPLES_PER_CLASS")
    return argv[:i] + ([] if device == "cuda" else ["--device", device]) + argv[i:] + CARDS_OPTS


def cards_outputs(out: Path) -> tuple:
    """A run's sweep scores ``{(lr, wd): score}`` and its test predictions."""
    (cache,) = (out / "out" / "cifar-10" / "sweep_cache").iterdir()
    scores = {(r["lr"], r["wd"]): r["score"]
              for r in map(json.loads, cache.read_text().splitlines())}
    folder = out / "out" / "predictions" / "finetuning_5"
    preds = np.asarray(json.loads((folder / "seed0_cifar-10.json").read_text())["predictions"][0])
    return scores, preds


def mesh_card_rank_main(out: str, device: str) -> int:
    """One rank of ``--mesh-cards``' world: the command, which joins the
    world from the launcher's variables (NCCL, ``cuda:{LOCAL_RANK}``)."""
    from pevit_tpu_torch.commands import kronecker_adaptation_clip
    from pevit_tpu_torch.utils import dist

    t0 = time.perf_counter()
    best, info = kronecker_adaptation_clip.main(cards_argv(Path(out), device))
    print(f"rank {dist.rank()} of {dist.world_size()} ({torch.distributed.get_backend()}): "
          f"best {best}, lr {info['best_lr']}, wd {info['best_l2_lambda']}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dist.barrier()
    torch.distributed.destroy_process_group()
    return 0


def mesh_cards_main(device: str = "cuda") -> int:
    """The KAdaptation command with its sweep, fp32, once in this process on
    one card and once in a world of one rank a card (NCCL): the sweep's
    trial chunks cut over the ranks, the final run's full batches over
    them.  Every sweep score, the chosen (lr, wd) and the test predictions
    (within 1e-5 of the largest) must agree."""
    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from pevit_tpu_torch.commands import kronecker_adaptation_clip

    n = torch.cuda.device_count() if device == "cuda" else 2
    if n < 2:
        raise AssertionError(f"--mesh-cards needs two cards or more; this host has {n}")
    card = card_line() if device == "cuda" else "CPU"
    print(card, flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        best, info = kronecker_adaptation_clip.main(cards_argv(tmp / "one", device))
        one_s = time.perf_counter() - t0
        close_command_logs()
        port, procs = free_port(), []
        t0 = time.perf_counter()
        for rank in range(n):
            with launcher_env(n, rank, port):
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--mesh-card-rank",
                     str(tmp / "world"), device],
                    cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=1800)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        world_s = time.perf_counter() - t0
        for rank, (p, log) in enumerate(zip(procs, logs)):
            print("\n".join(x for x in log.splitlines() if x.startswith(f"rank {rank} ")),
                  flush=True)
            if p.returncode != 0:
                raise AssertionError(f"--mesh-cards rank {rank} failed:\n{log[-6000:]}")
        one_scores, one_preds = cards_outputs(tmp / "one")
        world_scores, world_preds = cards_outputs(tmp / "world")
    chosen = f"lr {info['best_lr']}, wd {info['best_l2_lambda']}"
    gap = float(np.abs(world_preds - one_preds).max() / np.abs(one_preds).max())
    out = {"cards": n, "trials": len(one_scores), "chosen": chosen, "best": best,
           "scores_equal": one_scores == world_scores, "prediction_gap": gap,
           "seconds": {"one": one_s, "world": world_s}}
    print(f"mesh across cards: {json.dumps(out)} [{card}]", flush=True)
    if not out["scores_equal"] or gap > 1e-5 or not all(chosen in log for log in logs):
        raise AssertionError(f"--mesh-cards: the world and one process disagree: {out}")
    return 0


# ---------------------------------------------------------------------------
# 15. CLIP ViT-L/14 at 336 px (N = 577), served and trained
# ---------------------------------------------------------------------------

L336_SEED = 13
L336_CLASSES = 64  # = the largest served batch: one class an image
L336_SERVE_BATCHES = (1, 8, 64)
# 96 train images at batch 32 (3 steps, one epoch) and 32 val images (one
# eval chunk), noisy copies of the prototypes
L336_TRAIN, L336_VAL, L336_BATCH = 96, 32, 32


def vitl14_336():
    """OpenAI's CLIP ViT-L/14@336px: ViT-L/14 at 336 px, 24^2 + 1 = 577 tokens."""
    from pevit_tpu_torch.core import CLIPSpec

    base = CLIPSpec.vit_l14()
    return dataclasses.replace(base, vision=dataclasses.replace(base.vision,
                                                                input_resolution=336))


def load_vitl14_336(tmp: Path) -> tuple:
    """A seeded ViT-L/14@336px CLIP (both towers) written as an OpenAI-layout
    state dict and read back by ``load_clip`` onto the card: the spec from
    the checkpoint's keys (input_resolution 336 from the 577-row positional
    embedding), every tensor bit for bit.  Returns (clip, spec, summary)."""
    from pevit_tpu_torch.ckpt import clip_to_state_dict, load_clip
    from pevit_tpu_torch.core import init_clip_params

    want_spec = vitl14_336()
    t0 = time.perf_counter()
    src = init_clip_params(torch.Generator().manual_seed(L336_SEED), want_spec, device="cuda")
    path = tmp / "ViT-L-14-336px.pt"
    sd = clip_to_state_dict(src)
    rows = sd["visual.positional_embedding"].shape[0]
    if rows != want_spec.vision.seq_len:
        raise AssertionError(f"{rows} positions, want {want_spec.vision.seq_len}")
    torch.save(sd, path)
    del sd
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clip, spec = load_clip("ViT-L/14@336px", checkpoint_path=str(path), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if spec != want_spec:  # input_resolution 336, N = 577
        raise AssertionError(f"loaded {spec}, want {want_spec}")
    got, want = clip.state_dict(), src.state_dict()
    bad = [k for k, t in want.items() if k not in got or not torch.equal(got[k], t)]
    if bad or got.keys() != want.keys():
        raise AssertionError(f"ViT-L/14@336px: {len(bad)} of {len(want)} tensors differ, "
                             f"e.g. {bad[:3]}")
    summary = {"write_s": write_s, "load_s": load_s, "file_bytes": path.stat().st_size,
               "tensors": len(want), "input_resolution": spec.vision.input_resolution,
               "tokens": spec.vision.seq_len}
    path.unlink()
    return clip, spec, summary


# the kernels of each of K1-K3 by name, for a profile's shares: K2's and
# K3's GEMMs and K3's own row passes and transposes (the LayerNorm row
# pass, which both run, apart)
KERNEL_GROUPS = {"attention_fwd": ("attention_fwd",),
                 "fused_mlp_fwd": ("gemm_fc_", "gemm_proj_"),
                 "fused_mlp_bwd": ("gemm_dh_", "gemm_du_", "ln_bwd_rows", "transpose_kernel"),
                 "ln_rows": ("ln_rows_kernel",)}


def kernel_share(fn, groups: dict) -> dict:
    """Device ms of ``fn`` under a CUDA-only profiler trace: the card's busy
    time (the union of its kernel and copy intervals) and, for each group
    of ``groups`` ({label: name parts}), the time of the kernels whose name
    holds one of its parts, and that share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    busy = busy_ms(events)
    out = {"busy_ms": busy}
    for label, parts in groups.items():
        own = sum(e.end_ns() - e.start_ns() for e in events
                  if any(part in e.name() for part in parts)) / 1e6
        out.update({f"{label}_ms": own, f"{label}_share": own / busy})
    return out


def tower_batches(spec, train: dict, evals: dict, fused_mlp_bwd: bool) -> dict:
    """A bf16 KAdaptation path's batches on the tower of ``spec``."""
    v = spec.vision
    return {"dtype": "bfloat16", "train": collections.Counter(train),
            "evals": collections.Counter(evals), "layers": v.layers, "width": v.width,
            "tokens": v.seq_len, "heads": v.heads, "head_dim": v.width // v.heads,
            "fused_mlp": True, "fused_mlp_bwd": fused_mlp_bwd}


def tower_serve(kernels, clip, spec, rng, *, seed: int, classes: int, batches: tuple,
                what: str, k1_body: tuple = (), after=None) -> tuple:
    """The bf16 KAdaptation classifier on the tower ``clip`` through
    ``make_serving_fn`` on uint8 images: a K1 and a K2 launch a block a
    forward at each of ``batches``; logits and top-1 against the plain path
    on the card at each (``compare_plain``), the head fitted to the
    prototypes' features in batches of that size; images/s at the largest;
    K1's and K2's shares of a forward there from a CUDA-only profile (and,
    with ``k1_body``, the name parts of the K1 body every launch must run,
    that body's time, which must be all of K1's); with ``after``, its
    result on (serving fn, the largest batch's images) as ``after``.
    Returns (summary, launches, batches, prototypes)."""
    from pevit_tpu_torch.serve import make_serving_fn

    static, trainable, frozen, bn, preproc = build_classifier(
        seed, num_classes=classes, tower=(clip, spec))
    res = spec.vision.input_resolution
    # the served batch, one class per image, its head fitted to it (as
    # phase 8's): the logits separate the classes by the tower's features,
    # so a top-1 comparison tests the kernels and not near-ties
    prototypes = rng.integers(0, 256, (classes, res, res, 3), dtype=np.uint8)
    serve = make_serving_fn(static, trainable, frozen, bn, preproc, device="cuda")
    n = max(batches)
    images = torch.from_numpy(prototypes[:n]).cuda()
    labels = torch.arange(n).cuda()
    serve(images[:1])  # warm-up
    torch.cuda.synchronize()
    layers = spec.vision.layers
    want = {"attention_fwd": layers, "fused_mlp_fwd": layers, "fused_mlp_bwd": 0}
    launches, checks = collections.Counter(), {}
    for b in sorted(batches):  # the largest last: the timed batch
        fit_prototype_head(static, trainable, frozen, bn, preproc, prototypes, chunk=b)
        before = read_launches(kernels)
        logits = serve(images[:b])
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in read_launches(kernels).items()}
        if got != want or logits.shape != (b, classes):
            raise AssertionError(f"{what} forward of {b}: launches {got}, want {want}; "
                                 f"logits {tuple(logits.shape)}")
        launches.update(got)
        checks[b] = compare_plain(serve, images[:b], labels[:b], torch.bfloat16)
    launches = {k.name: launches[k.name] for k in kernels}
    ms = time_ms(lambda: serve(images), reps=5)
    groups = {k: KERNEL_GROUPS[k] for k in ("attention_fwd", "fused_mlp_fwd", "ln_rows")}
    share = kernel_share(lambda: serve(images), body_groups(groups, k1_body))
    all_in_body(share, k1_body, f"{what} forward of {n}")
    summary = {"launches": launches, "vs_plain": checks, "forward_ms": ms,
               "images_per_s": n / ms * 1e3, "kernel_shares_of_forward": share}
    if after is not None:
        summary["after"] = after(serve, images)
    return (summary, launches, tower_batches(spec, {}, {b: 1 for b in batches}, False),
            prototypes)


def body_groups(groups: dict, k1_body: tuple) -> dict:
    """``groups`` and, with ``k1_body`` (name parts), the K1 body's."""
    return {**groups, "k1_body": k1_body} if k1_body else groups


def all_in_body(share: dict, k1_body: tuple, what: str) -> None:
    """With ``k1_body``, every K1 kernel of the profile ``share`` ran that
    body: its device time is all of K1's, and not none."""
    if k1_body and not (0 < share["k1_body_ms"] and
                        abs(share["k1_body_ms"] - share["attention_fwd_ms"])
                        <= 1e-6 * share["attention_fwd_ms"]):
        raise AssertionError(f"{what}: K1 ran {share['attention_fwd_ms']} ms, of which "
                             f"{share['k1_body_ms']} in its body {k1_body}")


def step_shares(task, data, k1_body: tuple = ()) -> dict:
    """Each kernel's share of a bf16 train step's device time (one epoch of
    3 full batches on the bundle the main run trained, under a CUDA-only
    profile, after a warm-up epoch), and the step's wall ms; with
    ``k1_body``, K1's time all in that body."""
    from pevit_tpu_torch.train import build_epoch_fn

    n = 3 * task.static.batch_size
    images = task.prepack(data[0][:n])
    labels = torch.as_tensor(data[1][:n]).cuda()
    epoch = build_epoch_fn(task.static, n, task.preproc)
    state = epoch(task.last_bundle, images, labels, task.last_state, TRAIN_LR, TRAIN_WD)
    torch.cuda.synchronize()
    shares = kernel_share(
        lambda: epoch(task.last_bundle, images, labels, state, TRAIN_LR, TRAIN_WD),
        body_groups(KERNEL_GROUPS, k1_body))
    all_in_body(shares, k1_body, "a train epoch")
    return {**shares, "steps": 3, "busy_ms_per_step": shares["busy_ms"] / 3}


def tower_train(kernels, clip, spec, prototypes, rng, *, classes: int, n_train: int,
                n_val: int, batch: int, shares: bool = False, grad_batch: int = 0,
                k1_body: tuple = (), after=None) -> tuple:
    """A bf16 KAdaptation run at ``batch`` (dropout 0.5): the steps of
    ``n_train`` images and one eval chunk of ``n_val`` through
    ``train_trials``, a K1, K2 and K3 launch a block a step (K1 and K2 also
    an eval chunk), the card's peak allocation; train images/s; with
    ``shares`` each kernel's share of a step (``step_shares``, ``k1_body``
    as there); first-step fp32 gradients against the plain path at phase
    5's limits, at ``grad_batch`` images (``batch`` unless given); with
    ``after``, its result on (task, data) as ``after``.  Returns (summary,
    launches, batches)."""
    def noisy(n):
        labels = np.arange(n) % classes
        noise = rng.integers(-8, 9, (n,) + prototypes.shape[1:], dtype=np.int16)
        return np.clip(prototypes[labels].astype(np.int16) + noise, 0, 255).astype(np.uint8), \
            labels

    data = (*noisy(n_train), *noisy(n_val))
    task = make_task(clip, "bfloat16", dropout_p=0.5, batch=batch, spec=spec)
    torch.cuda.reset_peak_memory_stats()
    run = train_run(task, data, kernels, epochs=1)  # the launches held exact
    peak = torch.cuda.max_memory_allocated()
    ips = train_throughput(task, data)
    summary = {**run, "peak_allocated_gb": peak / 1e9, "train_images_per_s": ips}
    if shares:
        summary["kernel_shares_of_a_step"] = step_shares(task, data, k1_body)
    if after is not None:
        summary["after"] = after(task, data)
    del task
    grad_batch = grad_batch or batch
    summary["first_step_grads"] = {**compare_grads(
        make_task(clip, "float32", 0.0, batch=grad_batch, spec=spec), data[0][:grad_batch],
        data[1][:grad_batch], torch.float32), "images": grad_batch}
    batches = tower_batches(spec, {batch: run["train_steps"]}, {n_val: run["eval_chunks"]}, True)
    return summary, run["launches"], batches


def run_vitl14_336(kernels, gen, card: str) -> tuple:
    """Phase 15: the 336 px checkpoint, serving and training, then every
    kernel against its plain version at each batch each path gave it."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(L336_SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_l336_") as tmp:
        clip, spec, ckpt = load_vitl14_336(Path(tmp))
    print(f"vitl14_336 checkpoint: {json.dumps(ckpt)} [{card}]", flush=True)
    serve, serve_launches, serve_batches, prototypes = tower_serve(
        kernels, clip, spec, rng, seed=L336_SEED, classes=L336_CLASSES,
        batches=L336_SERVE_BATCHES, what="ViT-L/14@336")
    print(f"vitl14_336 serving bf16: {json.dumps(serve)} [{card}]", flush=True)
    train, train_launches, train_batches = tower_train(
        kernels, clip, spec, prototypes, rng, classes=L336_CLASSES, n_train=L336_TRAIN,
        n_val=L336_VAL, batch=L336_BATCH)
    print(f"vitl14_336 training bf16 batch {L336_BATCH}: {json.dumps(train)} [{card}]",
          flush=True)
    del clip
    launches = {"vitl14_336_serve": serve_launches, "vitl14_336_train": train_launches}
    table = path_kernel_rows(gen, "vitl14_336_serve", serve_batches)
    for name, rows_ in path_kernel_rows(gen, "vitl14_336_train", train_batches).items():
        table[name] += rows_
    for name, rows_ in table.items():
        for r in rows_:
            print(f"vitl14_336 kernel {name} {json.dumps(r)} [{card}]", flush=True)
    return launches, table, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# 16. ViT-H/14: CLIP's tower (C = 1280, K2 and K3 at the new width), at 378
# px too (N = 730, K1's bf16 body past 640 tokens), and MAE's (heads of 80,
# K1's fp32 body at the new head width)
# ---------------------------------------------------------------------------

H14_SEED = 17
H14_RES = 224
# DFN5B-CLIP-ViT-H-14-378's resolution (open_clip ViT-H-14-378-quickgelu):
# 27^2 + 1 = 730 tokens; its fp32 first-step gradients at 16 images (the
# plain path keeps float32 logits and probabilities of 32 layers, about 44
# GB at 16 images; at the training batch of 32 they would not fit the card)
H14_378_RES = 378
H14_378_GRAD_BATCH = 16
# the published widths: LAION's open CLIP ViT-H-14 (its vision and text
# towers and embedding; DFN5B's 378 px tower has the same widths) and MAE's
# ViT-H/14 (timm's vit_huge_patch14_224)
CLIP_H14 = {"width": 1280, "layers": 32, "patch": 14, "text_width": 1024, "text_heads": 16,
            "text_layers": 24, "embed": 1024}
MAE_H14 = {"width": 1280, "layers": 32, "heads": 16, "patch": 14}
H14_CLASSES = 64  # = the largest served batch: one class an image
H14_SERVE_BATCHES = (1, 8, 64)
# 96 train images at batch 32 (3 steps, one epoch) and 32 val images (one
# eval chunk), noisy copies of the prototypes, as phase 15's
H14_TRAIN, H14_VAL, H14_BATCH = 96, 32, 32
# MAE's finetune step and its gradients: 16 train and 16 val images
MAE_FT_BATCH = 16
MAE_FT_RATE = (1e-5, 1e-4)  # (lr, wd) at the finetune command's scale


def h14_tokens(patch: int, res: int = H14_RES) -> int:
    return (res // patch) ** 2 + 1


def clip_h14_config(res: int = H14_RES):
    """CLIP ViT-H/14 as a user's MODEL.SPEC gives it (``CLIP_H14``: the
    vision tower of LAION's open ViT-H-14, width 1280, 32 layers, patch 14;
    its text tower 1024 wide, 24 layers of 16 heads; embedding 1024), at
    ``res`` px (224 unless given), merged as the commands merge a model
    YAML: by the reference's rule the vision tower has 1280 // 64 = 20 heads
    of 64 (the published towers have 16 of 80)."""
    cfg = aux_config("vitb32_CLIP.yaml", "TRAIN.IMAGE_SIZE", f"[{res},{res}]")
    cfg.defrost()
    cfg.MODEL.NAME = "ViT-H/14"
    spec, h = cfg.MODEL.SPEC, CLIP_H14
    spec.EMBED_DIM = h["embed"]
    spec.VISION.WIDTH, spec.VISION.LAYERS, spec.VISION.PATCH_SIZE = h["width"], h["layers"], \
        h["patch"]
    spec.TEXT.WIDTH, spec.TEXT.HEADS, spec.TEXT.LAYERS = h["text_width"], h["text_heads"], \
        h["text_layers"]
    cfg.freeze()
    return cfg


def mae_h14_config(*opts):
    """MAE ViT-H/14 (``MAE_H14``: the MAE paper's and timm's
    ``vit_huge_patch14_224``, EMBED_DIM 1280, DEPTH 32, NUM_HEADS 16, patch
    14, the global pool) as a user's MODEL.SPEC gives it under an ``mae_``
    name, at 224 px: heads of 80."""
    cfg = aux_config("mae_vitb16.yaml", "TRAIN.IMAGE_SIZE", f"[{H14_RES},{H14_RES}]", *opts)
    cfg.defrost()
    cfg.MODEL.NAME = "mae_vit_huge_patch14"
    spec, h = cfg.MODEL.SPEC, MAE_H14
    spec.EMBED_DIM, spec.DEPTH, spec.NUM_HEADS, spec.PATCH_SIZE = h["width"], h["layers"], \
        h["heads"], h["patch"]
    spec.GLOBAL_POOL = True
    cfg.freeze()
    return cfg


def clip_h14(kernels, gen, card: str, rng) -> tuple:
    """16a: CLIP ViT-H/14 from its spec, seeded weights on the card;
    serving at batches 1, 8, 64 and training at batch 32, as phase 15 (32
    K1 and K2 a forward, 32 K1, K2 and K3 a step), with each kernel's share
    of a train step.  Returns (summaries, launches, table, tower), the
    tower for 16c."""
    from pevit_tpu_torch.core import CLIPSpec, init_clip_params

    spec = CLIPSpec.from_config(clip_h14_config())
    v, h = spec.vision, CLIP_H14
    if (v.width, v.layers, v.heads, v.seq_len) != (h["width"], h["layers"], h["width"] // 64,
                                                   h14_tokens(h["patch"])):
        raise AssertionError(f"CLIP ViT-H/14 spec {spec}")
    t0 = time.perf_counter()
    clip = init_clip_params(torch.Generator().manual_seed(H14_SEED), spec, device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "params_m": sum(p.numel() for p in clip.parameters()) / 1e6}
    out["serve"], serve_launches, serve_batches, prototypes = tower_serve(
        kernels, clip, spec, rng, seed=H14_SEED, classes=H14_CLASSES, batches=H14_SERVE_BATCHES,
        what="CLIP ViT-H/14")
    out["train"], train_launches, train_batches = tower_train(
        kernels, clip, spec, prototypes, rng, classes=H14_CLASSES, n_train=H14_TRAIN,
        n_val=H14_VAL, batch=H14_BATCH, shares=True)
    table = path_kernel_rows(gen, "clip_h14_serve", serve_batches)
    for name, rows_ in path_kernel_rows(gen, "clip_h14_train", train_batches).items():
        table[name] += rows_
    return out, {"clip_h14_serve": serve_launches, "clip_h14_train": train_launches}, table, clip


# the name parts (demangled or mangled) of K1's body past 640 tokens at hd
# 64 up to SMEM2_MAX_SEQ: the shared-memory body with the short ring
K1_SHORT_RING = ("attention_fwd_bf16_smem<2>", "attention_fwd_bf16_smemILi2E")


def clip_h14_378(kernels, gen, card: str, rng, clip) -> tuple:
    """16c: CLIP ViT-H/14 at 378 px from its spec (N = 730, 20 heads of
    64), on 16a's seeded tower with a fresh seeded 730-row positional
    embedding; served at batches 1, 8, 64 and trained at batch 32 as 16a
    (32 K1 and K2 a forward, 32 K1, K2 and K3 a step), every K1 launch on
    the body the launcher gives N = 730 (the short ring), which the
    profiles of a forward and of a train step see as all of K1's time;
    fp32 first-step gradients at H14_378_GRAD_BATCH images.  Returns
    (summaries, launches, table)."""
    from pevit_tpu_torch.core import CLIPSpec
    from pevit_tpu_torch.ops.attention import launch_plan

    spec = CLIPSpec.from_config(clip_h14_config(H14_378_RES))
    v, h = spec.vision, CLIP_H14
    if (v.width, v.layers, v.heads, v.seq_len) != (h["width"], h["layers"], h["width"] // 64,
                                                   h14_tokens(h["patch"], H14_378_RES)):
        raise AssertionError(f"CLIP ViT-H/14 at 378 px spec {spec}")
    batches = {*H14_SERVE_BATCHES, H14_BATCH, H14_VAL}
    bodies = {b: launch_plan(b, v.seq_len, v.heads, v.width // v.heads, torch.bfloat16).body
              for b in batches}
    if set(bodies.values()) != {"bf16_smem2"}:
        raise AssertionError(f"K1 at N = {v.seq_len} runs {bodies}, want the short ring")
    t0 = time.perf_counter()
    pos = torch.randn(v.seq_len, v.width, generator=torch.Generator().manual_seed(H14_SEED + 1))
    clip.visual.positional_embedding = torch.nn.Parameter((pos * v.width ** -0.5).cuda())
    out = {"init_s": time.perf_counter() - t0, "tokens": v.seq_len, "heads": v.heads,
           "k1_body": "bf16_smem2"}
    out["serve"], serve_launches, serve_batches, prototypes = tower_serve(
        kernels, clip, spec, rng, seed=H14_SEED, classes=H14_CLASSES, batches=H14_SERVE_BATCHES,
        what="CLIP ViT-H/14@378", k1_body=K1_SHORT_RING)
    out["train"], train_launches, train_batches = tower_train(
        kernels, clip, spec, prototypes, rng, classes=H14_CLASSES, n_train=H14_TRAIN,
        n_val=H14_VAL, batch=H14_BATCH, shares=True, grad_batch=H14_378_GRAD_BATCH,
        k1_body=K1_SHORT_RING)
    del clip
    torch.cuda.empty_cache()
    table = path_kernel_rows(gen, "clip_h14_378_serve", serve_batches)
    for name, rows_ in path_kernel_rows(gen, "clip_h14_378_train", train_batches).items():
        table[name] += rows_
    return (out, {"clip_h14_378_serve": serve_launches, "clip_h14_378_train": train_launches},
            table)


def mae_h14(kernels, gen, card: str, rng) -> tuple:
    """16b: MAE ViT-H/14 through ``get_model`` from its spec (seeded
    weights); a 64-image feature forward (32 K1 a forward on the fp32 body
    at hd 80, no K2) within 1e-4 of the plain path's; one ``full_finetune``
    step through ``train_trials`` (16 images, one eval chunk of 16: 32 K1
    each) and first-step gradients kernel vs plain path as phase 10's
    ViT-B/16 finetune (bf16 cosine >= 0.99, fp32 within 1e-3 of each leaf's
    largest |g|, the final LayerNorm's bias vanishing and its scale held to
    WITNESS_FACTOR x the float64 witness).  Returns (summaries, launches,
    table)."""
    from pevit_tpu_torch.core import CLIPSpec
    from pevit_tpu_torch.models import get_model
    from pevit_tpu_torch.peft import PeftConfig
    from pevit_tpu_torch.train import TaskStatic, TrainTask

    cfg = mae_h14_config("DATASET.NUM_CLASSES", str(MAE_FT_BATCH),
                         "TRAIN.BATCH_SIZE_PER_GPU", str(MAE_FT_BATCH))
    t0 = time.perf_counter()
    mae = get_model(cfg, device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "params_m": sum(p.numel() for p in mae.params.parameters()) / 1e6}
    h = MAE_H14
    tokens = h14_tokens(h["patch"])
    out["features"], forward_batches = aux_forward(kernels, mae, H14_RES, rng, tokens=tokens,
                                                   fused=False, layers=h["layers"],
                                                   width=h["width"], heads=h["heads"])

    static = TaskStatic.from_config(cfg, CLIPSpec.from_config(cfg),
                                    PeftConfig(method="full_finetune"), feat_dim=mae.feat_dim)
    task = TrainTask(cfg, static, None, device="cuda", backbone=mae)
    n = 2 * MAE_FT_BATCH
    images = rng.integers(0, 256, (n, H14_RES, H14_RES, 3), dtype=np.uint8)
    labels = np.arange(n) % MAE_FT_BATCH
    reset_launches(kernels)
    t0 = time.perf_counter()
    with recorded_calls([]) as calls:
        res = task.train_trials([MAE_FT_RATE], images[:MAE_FT_BATCH], labels[:MAE_FT_BATCH],
                                images[MAE_FT_BATCH:], labels[MAE_FT_BATCH:], end_epoch=1,
                                keep_logits=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels)
    step_batches = aux_batches(task, calls, tokens, fused_mlp=False, layers=h["layers"])
    step_batches.update(width=h["width"], heads=h["heads"], head_dim=h["width"] // h["heads"])
    if launches != expected_launches(step_batches) or not np.isfinite(res[0]["best_logits"]).all():
        raise AssertionError(f"MAE ViT-H/14 finetune step: launches {launches}, want "
                             f"{expected_launches(step_batches)}, or non-finite logits")
    ft = {"launches": launches, "seconds": seconds, "train_step_images": dict(step_batches["train"]),
          "eval_chunk_images": dict(step_batches["evals"]), "first_step_grads": []}
    x, y = images[:MAE_FT_BATCH], labels[:MAE_FT_BATCH]
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        variant = copy.copy(task)
        variant.static = dataclasses.replace(task.static, compute_dtype=dtype_name)
        limits = None
        if dtype == torch.float32:
            witness = witness_gaps(variant, x, y, VIT_WITNESSED)
            limits = {n: WITNESS_FACTOR * gap for n, gap in witness.items()}
        grads = compare_grads(variant, x, y, dtype, VIT_VANISHING, limits)
        if limits:
            for n, held in grads["held_to_limits"].items():
                held["witness_gap"] = witness[n]
        ft["first_step_grads"].append(grads)
    out["finetune"] = ft
    del task, mae
    torch.cuda.empty_cache()
    table = path_kernel_rows(gen, "mae_h14_forward", forward_batches)
    for name, rows_ in path_kernel_rows(gen, "mae_h14_finetune", step_batches).items():
        table[name] += rows_
    return (out, {"mae_h14_forward": out["features"]["launches"], "mae_h14_finetune": launches},
            table)


def run_vith14(kernels, gen, card: str) -> tuple:
    """Phase 16: CLIP ViT-H/14 (16a), the same at 378 px (16c, on 16a's
    tower, before 16b frees the card for MAE) and MAE ViT-H/14 (16b) at full
    width and depth on the card, then every kernel against its plain
    version at each batch each path gave it."""
    t0, steps = time.perf_counter(), {}
    rng = np.random.default_rng(H14_SEED)
    clip, clip_launches, table, tower = clip_h14(kernels, gen, card, rng)
    print(f"clip_h14: {json.dumps(clip)} [{card}]", flush=True)
    steps["clip"] = time.perf_counter() - t0
    at378, at378_launches, at378_table = clip_h14_378(kernels, gen, card, rng, tower)
    del tower
    print(f"clip_h14_378: {json.dumps(at378)} [{card}]", flush=True)
    steps["clip_378"] = time.perf_counter() - t0 - steps["clip"]
    mae, mae_launches, mae_table = mae_h14(kernels, gen, card, rng)
    print(f"mae_h14: {json.dumps(mae)} [{card}]", flush=True)
    steps["mae"] = time.perf_counter() - t0 - steps["clip"] - steps["clip_378"]
    for other in (at378_table, mae_table):
        for name, rows_ in other.items():
            table[name] += rows_
    for name, rows_ in table.items():
        for r in rows_:
            print(f"vith14 kernel {name} {json.dumps(r)} [{card}]", flush=True)
    print(f"phase 16 seconds by step: {json.dumps(steps)}", flush=True)
    return ({**clip_launches, **at378_launches, **mae_launches}, table,
            time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 17. CLIP ViT-B/16 in bf16 (N = 197): K1's persistent body on the path, and
# against the register body end to end
# ---------------------------------------------------------------------------

B16_SEED = 19
B16_CLASSES = 256  # = the served batch: one class an image
B16_TRAIN_CLASSES = 100  # the trained task's head (make_task's), on the first 100 prototypes
# 384 train images at batch 128 (3 steps, one epoch) and 64 val images (one
# eval chunk), noisy copies of the prototypes; fp32 first-step gradients at
# 16 images (the plain path's float32 logits and probabilities of 12 layers)
B16_TRAIN, B16_VAL, B16_GRAD_BATCH = 384, 64, 16


def k1_tma_body(keys: int) -> tuple:
    """The name parts (demangled or mangled) of K1's persistent body built
    for ``keys`` keys."""
    return (f"attention_fwd_bf16_tma<{keys}>", f"attention_fwd_bf16_tmaILi{keys}E")


def serving_turns(regs):
    """``tower_serve``'s ``after``: the served batch's forward with the
    launcher's K1 (the persistent body) and with the register body
    (``regs``, phase 3's aid) in turns (persistent, register, register,
    persistent): images/s, the mean of each one's two medians, and K1's
    share of a forward under each from a CUDA-only profile."""
    from pevit_tpu_torch.tools.attention_bodies import launching

    def after(serve, images):
        turns, shares = {"tma": [], "regs": []}, {}
        for name in ("tma", "regs", "regs", "tma"):
            with launching(regs) if name == "regs" else contextlib.nullcontext():
                turns[name].append(time_ms(lambda: serve(images), reps=5))
        for name in ("tma", "regs"):
            with launching(regs) if name == "regs" else contextlib.nullcontext():
                shares[name] = kernel_share(lambda: serve(images),
                                            {"attention_fwd": KERNEL_GROUPS["attention_fwd"]})
        n = len(images)
        return {"forward_ms_turns": turns,
                "images_per_s": {k: n / statistics.mean(v) * 1e3 for k, v in turns.items()},
                "k1_share_of_forward": {k: v["attention_fwd_share"] for k, v in shares.items()},
                "k1_ms_of_forward": {k: v["attention_fwd_ms"] for k, v in shares.items()},
                "busy_ms_of_forward": {k: v["busy_ms"] for k, v in shares.items()}}
    return after


def training_turns(regs):
    """``tower_train``'s ``after``: train images/s (``train_throughput``)
    with the persistent body and with the register body in turns, as
    :func:`serving_turns`."""
    from pevit_tpu_torch.tools.attention_bodies import launching

    def after(task, data):
        turns = {"tma": [], "regs": []}
        for name in ("tma", "regs", "regs", "tma"):
            with launching(regs) if name == "regs" else contextlib.nullcontext():
                turns[name].append(train_throughput(task, data))
        return {"images_per_s_turns": turns,
                "images_per_s": {k: statistics.mean(v) for k, v in turns.items()}}
    return after


def run_vitb16(kernels, gen, card: str, regs) -> tuple:
    """Phase 17: CLIP ViT-B/16 (``vitb16_CLIP.yaml``: 12 x 768, patch 16, N
    = 197) at full width and depth from seeded weights, every K1 launch on
    the persistent body (the launch plan at every batch, and the CUDA-only
    profiles of a forward and a train step, whose K1 time is all that
    body's): the bf16 KAdaptation classifier served at batch 256 (12 K1 and
    12 K2 a forward, top-1 against the plain path, images/s, K1's share of
    a forward) and trained at batch 128 (3 steps and one eval chunk; 12 K1,
    K2 and K3 a step; fp32 first-step gradients at 16 images within 1e-3 of
    each leaf's largest |g|); serving and train images/s and K1's share of
    a forward with the persistent body and with the register body
    (``regs``, phase 3's aid) in turns; then every kernel against its plain
    version at each batch each path gave it."""
    from pevit_tpu_torch.core import CLIPSpec, init_clip_params
    from pevit_tpu_torch.ops.attention import launch_plan

    t0 = time.perf_counter()
    spec = CLIPSpec.from_config(aux_config("vitb16_CLIP.yaml"))
    v = spec.vision
    if (v.width, v.layers, v.heads, v.patch_size, v.seq_len) != (768, 12, 12, 16, 197):
        raise AssertionError(f"CLIP ViT-B/16 spec {spec}")
    plans = {b: launch_plan(b, v.seq_len, v.heads, v.width // v.heads, torch.bfloat16)
             for b in (SERVE_BATCH, TRAIN_BATCH, B16_VAL)}
    if {(p.body, p.keys) for p in plans.values()} != {("bf16_tma", 200)}:
        raise AssertionError(f"K1 at N = {v.seq_len} runs {plans}, want the persistent body")
    body = k1_tma_body(200)
    clip = init_clip_params(torch.Generator().manual_seed(B16_SEED), spec, device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "tokens": v.seq_len, "k1_body": body[0]}
    rng = np.random.default_rng(B16_SEED)
    out["serve"], serve_launches, serve_batches, prototypes = tower_serve(
        kernels, clip, spec, rng, seed=B16_SEED, classes=B16_CLASSES, batches=(SERVE_BATCH,),
        what="CLIP ViT-B/16", k1_body=body, after=serving_turns(regs))
    out["train"], train_launches, train_batches = tower_train(
        kernels, clip, spec, prototypes, rng, classes=B16_TRAIN_CLASSES, n_train=B16_TRAIN,
        n_val=B16_VAL, batch=TRAIN_BATCH, shares=True, grad_batch=B16_GRAD_BATCH,
        k1_body=body, after=training_turns(regs))
    print(f"vitb16: {json.dumps(out)} [{card}]", flush=True)
    del clip
    torch.cuda.empty_cache()
    table = path_kernel_rows(gen, "vitb16_serve", serve_batches)
    for name, rows_ in path_kernel_rows(gen, "vitb16_train", train_batches).items():
        table[name] += rows_
    for name, rows_ in table.items():
        for r in rows_:
            print(f"vitb16 kernel {name} {json.dumps(r)} [{card}]", flush=True)
    return ({"vitb16_serve": serve_launches, "vitb16_train": train_launches}, table,
            time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    from pevit_tpu_torch.ops import KERNELS, build_all
    from pevit_tpu_torch.serve import InferencePipeline, make_serving_fn
    from pevit_tpu_torch.utils.device import resolve_device

    # 1. card (every phase prints its seconds, for comparing runs)
    start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build (and, beside the kernels, K1 with its bf16 shapes sent to the
    # shared-memory body and to the three-walk body, phase 3's aids), every
    # nvcc started together
    from pevit_tpu_torch.ops._build import _finish

    t0 = time.perf_counter()
    bodies_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_k1_")
    bodies = k1_bodies(Path(bodies_dir.name))
    aid_builds = [kernel.start_build() for kernel in bodies.values()]
    logs = build_all(KERNELS)
    for build in aid_builds:
        _finish(build)
    print(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        print("\n".join(ptxas_summary(name, log)), flush=True)

    # 3. kernels
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = SERVE_BATCH * 50
    table = {"attention_fwd": [], "fused_mlp_fwd": [], "fused_mlp_bwd": []}
    for dtype in (torch.bfloat16, torch.float32):
        for n in (50, 197, 257):
            table["attention_fwd"].append(check_attention(gen, dtype, n))
        # ViT-L/14 at 336 px (16 heads) at phase 15's training batch, and N = 1025
        for n, batch in ((577, L336_BATCH), (1025, 8)):
            table["attention_fwd"].append(check_attention(gen, dtype, n, batch, 16))
        for c in (768, 1024):
            table["fused_mlp_fwd"].append(check_fused_mlp(gen, dtype, c, rows))
    for batch in (TRAIN_BATCH, EVAL_REMAINDER):
        table["attention_fwd"].append(check_attention(gen, torch.bfloat16, 50, batch))
    # a ViT-B/16 backbone's 64-image fp32 forward (phase 10)
    table["attention_fwd"].append(check_attention(gen, torch.float32, 197, AUX_BATCH))
    table["fused_mlp_fwd"].append(check_fused_mlp(gen, torch.bfloat16, 768, TRAIN_BATCH * 50))

    # 3b. the fused-MLP backward, and the attention core's plain backward
    for dtype in (torch.bfloat16, torch.float32):
        for c in (768, 1024):
            table["fused_mlp_bwd"].append(check_fused_mlp_bwd(gen, dtype, c, TRAIN_BATCH * 50))
    for batch in (TRAIN_TAIL, EVAL_REMAINDER):
        table["fused_mlp_bwd"].append(check_fused_mlp_bwd(gen, torch.bfloat16, 768, batch * 50))
    for batch in (TRAIN_TAIL, EVAL_REMAINDER):
        table["fused_mlp_fwd"].append(check_fused_mlp(gen, torch.bfloat16, 768, batch * 50))
    for name, rows_ in table.items():
        for r in rows_:
            print(f"kernel {name} {json.dumps(r)} [{card}]", flush=True)
    # K1's persistent body against the register body at every N <= 257 row
    # of attention_bodies.SHAPES, and beside the shared-memory and three-walk
    # bodies at the serving batch
    body_rows = []
    for n, heads, batch in tma_rows():
        others = ("smem", "long") if batch == SERVE_BATCH else ()
        body_rows.append(time_bf16_bodies(gen, bodies, n, batch, heads, others))
        print(f"kernel attention_fwd bf16 bodies {json.dumps(body_rows[-1])} [{card}]",
              flush=True)
    idle = [r["shape"] for rows_ in table.values() for r in rows_
            if r["dtype"] == "float32" and not r["tf32_engaged"]]
    if idle:
        raise AssertionError(f"the TF32 control ran in float32 at phase 3's rows {idle}")
    attn_bwd = time_attention_bwd(gen, torch.bfloat16, 50, TRAIN_BATCH)
    print(f"plain attention_bwd_ref {json.dumps(attn_bwd)} [{card}]", flush=True)
    print(f"phases 3, 3b: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3c. the kernels at the shapes beyond ViT-B's: head widths, model widths
    t0 = time.perf_counter()
    for name, rows_ in check_kernel_shapes(gen).items():
        for r in rows_:
            print(f"kernel shapes {name} {json.dumps(r)} [{card}]", flush=True)
    smem_rows = check_smem_body(gen, bodies)
    for r in smem_rows:
        print(f"kernel smem body {json.dumps(r)} [{card}]", flush=True)
    print(f"phase 3c: {time.perf_counter() - t0:.1f} s", flush=True)

    # 4. serving
    t0 = time.perf_counter()
    static, trainable, frozen, bn, preproc = build_classifier(seed=0)
    res = static.spec.vision.input_resolution
    rng = np.random.default_rng(0)
    prototypes = rng.integers(0, 256, (static.num_classes, res, res, 3), dtype=np.uint8)
    fit_prototype_head(static, trainable, frozen, bn, preproc, prototypes)
    serve = make_serving_fn(static, trainable, frozen, bn, preproc, device="cuda")
    serve(prototypes[:8])  # warm-up
    torch.cuda.synchronize()
    run = serve_requests(serve, [k for k in KERNELS if k.name != "fused_mlp_bwd"], res, rng)
    lat = run["stats"]["latency"]
    print(f"served {run['images']} images in 16 requests, {run['forwards']} forwards, "
          f"launches {run['launches']}; latency {json.dumps(lat)} [{card}]", flush=True)

    # noisy copies of the prototypes, each labelled with its prototype's class
    labels = np.arange(SERVE_BATCH) % static.num_classes
    noise = rng.integers(-8, 9, (SERVE_BATCH, res, res, 3))
    batch = torch.from_numpy(np.clip(prototypes[labels] + noise, 0, 255).astype(np.uint8))
    labels = torch.from_numpy(labels).cuda()
    checks = [compare_plain(serve, batch.cuda(), labels, torch.bfloat16)]
    static32 = dataclasses.replace(static, compute_dtype="float32")
    serve32 = make_serving_fn(static32, trainable, frozen, bn, preproc, device="cuda")
    checks.append(compare_plain(serve32, batch[:64].cuda(), labels[:64], torch.float32))
    for c in checks:
        print(f"serving logits kernel vs plain path: {json.dumps(c)}", flush=True)

    pipe = InferencePipeline(serve, device="cuda", max_batch=SERVE_BATCH)
    stream = [batch.numpy()] * 8
    pipe.run(stream[:1])
    pipe.stats.update(images=0, batches=0, seconds=0.0)
    pipe.run(stream)
    print(f"throughput bf16 batch {SERVE_BATCH}: {pipe.throughput} images/s [{card}]",
          flush=True)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s", flush=True)

    # 5. training
    t0 = time.perf_counter()
    clip = frozen["clip"]
    data = train_data(prototypes, rng)
    task = make_task(clip, "bfloat16", dropout_p=0.5)
    train = train_run(task, data, KERNELS)
    print(f"trained bf16 batch {TRAIN_BATCH}, dropout 0.5: {json.dumps(train)} [{card}]",
          flush=True)
    ips = train_throughput(task, data)
    print(f"train throughput bf16 batch {TRAIN_BATCH}: {ips} images/s [{card}]", flush=True)
    # float32 training (TPU.PARITY_FP32, MODEL.CLIP_FP32): K3's fp32 body
    # runs 12 times a step
    task32 = make_task(clip, "float32", 0.0)
    train32 = train_run(task32, data, KERNELS)
    ips32 = train_throughput(task32, data)
    k3_shape = f"R={TRAIN_BATCH * 50} C=768 F=3072"
    k3_ms = next(r["ms"] for r in table["fused_mlp_bwd"]
                 if r["dtype"] == "float32" and r["shape"] == k3_shape)
    print(f"train throughput fp32 batch {TRAIN_BATCH}: {ips32} images/s (bf16 {ips}); a step "
          f"{1e3 * TRAIN_BATCH / ips32} ms, K3's share 12 x {k3_ms} = {12 * k3_ms} ms; "
          f"{json.dumps(train32)} [{card}]", flush=True)
    batch_x, batch_y = data[0][:TRAIN_BATCH], data[1][:TRAIN_BATCH]
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        gaps = compare_grads(make_task(clip, dtype_name, 0.0), batch_x, batch_y, dtype)
        print(f"first-step gradients kernel vs plain path: {json.dumps(gaps)} [{card}]",
              flush=True)
    run32 = compare_whole_run(make_task(clip, "float32", 0.0), data)
    print(f"whole-run val logits kernel vs plain path: {json.dumps(run32)} [{card}]", flush=True)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cmd_") as cmd_tmp:
        # 6. the command, then every kernel at the batches it gave each one
        t0 = time.perf_counter()
        command = run_command(KERNELS, Path(cmd_tmp))
        batches = command.pop("batches")
        print(f"command kronecker_adaptation_clip: {json.dumps(command)} [{card}]", flush=True)
        command_table = path_kernel_rows(gen, "command", batches)
        for name, rows_ in command_table.items():
            for r in rows_:
                print(f"command kernel {name} {json.dumps(r)} [{card}]", flush=True)
        print(f"phase 6: {time.perf_counter() - t0:.1f} s", flush=True)

        # 7. the other entry points: checkpoint, zero-shot, linear probe,
        # finetune, native resize
        t0 = time.perf_counter()
        launches, entry_table = run_entry_points(KERNELS, gen, card)
        print(f"native resize: {json.dumps(native_resize(rng))} [{card}]", flush=True)
        print(f"phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

        # 8. the baselines, their commands into phase 6's output directory
        t0 = time.perf_counter()
        base_launches, base_table = run_baselines(KERNELS, gen, card, Path(cmd_tmp), clip,
                                                  (batch_x, batch_y))
        print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)

        # 9. the deployment path: exported and int8 artifacts, the daemon
        # from phase 6's checkpoint, the serving benchmark, the FLOP ledger
        (Path(cmd_tmp) / "artifacts").mkdir()
        deploy_launches, deploy_table, seconds = run_deployment(
            KERNELS, gen, card, Path(cmd_tmp), pipe.throughput, (batch_x, batch_y))
        print(f"phase 9: {seconds:.1f} s", flush=True)

    # 10. the auxiliary backbones: the ViT family, the DeCLIP family, RN50
    aux_launches, aux_table, seconds = run_aux_backbones(KERNELS, gen, card)
    print(f"phase 10: {seconds:.1f} s", flush=True)

    # 11. streaming: a train split in host memory, right, at full size and
    # through the command
    stream_launches, stream_table, seconds = run_streaming(KERNELS, gen, card, clip, prototypes)
    print(f"phase 11: {seconds:.1f} s", flush=True)

    # 12. trial batches: a chunk's trials as one batch, against the serial
    # path, at the default chunk width, and halved out of memory
    trial_launches_, trial_table, seconds = run_trial_batches(KERNELS, gen, card, clip, data)
    print(f"phase 12: {seconds:.1f} s", flush=True)

    # 13. trial axis II: full fine-tuning and the auxiliary backbones, a
    # chunk's trials as one batch against the serial path
    axis_launches, axis_table, seconds = run_trial_axis(KERNELS, gen, card, clip, data)
    print(f"phase 13: {seconds:.1f} s", flush=True)

    # 14. the mesh: a world of one over NCCL, then a 2-rank gloo world on
    # the card: trials over ranks, the final run over data, tensor
    # parallelism, mesh serving, against this process without a world
    mesh_launches, mesh_table, seconds = run_mesh(KERNELS, gen, card, clip, prototypes)
    print(f"phase 14: {seconds:.1f} s", flush=True)

    # 15. CLIP ViT-L/14 at 336 px (N = 577): the checkpoint, serving and
    # training at full width
    l336_launches, l336_table, seconds = run_vitl14_336(KERNELS, gen, card)
    print(f"phase 15: {seconds:.1f} s", flush=True)

    # 16. ViT-H/14: CLIP's tower at C = 1280 and MAE's heads of 80, served
    # and trained at full width
    h14_launches, h14_table, seconds = run_vith14(KERNELS, gen, card)
    print(f"phase 16: {seconds:.1f} s", flush=True)

    # 17. CLIP ViT-B/16 in bf16: K1's persistent body on the path, against
    # the register body (phase 3's aid) in turns
    b16_launches, b16_table, seconds = run_vitb16(KERNELS, gen, card, bodies["regs"])
    bodies_dir.cleanup()
    print(f"phase 17: {seconds:.1f} s", flush=True)

    # 18. report (the register body, on no path, with phase 3's rows)
    launches = {"command": command["launches"], **launches, **base_launches, **deploy_launches,
                **aux_launches, **stream_launches, **trial_launches_, **axis_launches,
                **mesh_launches, **l336_launches, **h14_launches, **b16_launches}
    table = {name: command_table[name] + entry_table[name] + base_table[name]
             + deploy_table[name] + aux_table[name] + stream_table[name] + trial_table[name]
             + axis_table[name] + mesh_table[name] + l336_table[name] + h14_table[name]
             + b16_table[name] for name in command_table}
    regs_rows = [{**r, "body": "bf16_regs", "max_abs_err": r["regs_max_abs_err"],
                  "ms": r["regs_ms"]} for r in body_rows if r["shape"].startswith(
                      f"B*H={SERVE_BATCH}*")]
    report = kernel_report(KERNELS, launches, table, {"attention_fwd": smem_rows + regs_rows})
    print(f"script: {time.perf_counter() - start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank_main(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-card-rank":
        sys.exit(mesh_card_rank_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) >= 2 and sys.argv[1] == "--mesh-cards":
        sys.exit(mesh_cards_main(*sys.argv[2:3]))
    sys.exit(main())
