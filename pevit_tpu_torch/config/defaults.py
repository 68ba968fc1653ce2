"""Default configuration tree.

A copy of ``pevit_tpu/config/defaults.py``'s tree, key for key, so that
``TaskStatic.from_config`` and ``TrainTask`` read the same config objects on
both stacks.  The ``TPU`` node is kept whole: the port reads ``PARITY_FP32``
and ``COMPUTE_DTYPE`` as numeric semantics and ignores the TPU-side knobs
(see ``train/trainer.py``).  ``update_config`` is the CLI's YAML + override +
world-size merge.

Key-for-key compatible with the reference yacs tree
(vision_benchmark/config/default.py:7-234) so the published dataset/model YAML
files and the ``KEY VALUE`` CLI override grammar work unchanged.  Dead nodes
the reference carries (AMP, SWA, CUDNN, DEEPSPEED, FINETUNE) are kept so that
existing YAMLs/scripts don't error, but are not consumed — exactly like the
reference.  The typo'd key ``KNOWLEDGE.AGGREGATION.MEHTOD`` is preserved
verbatim (reference default.py:98) because published launch scripts set it.

TPU-specific additions live under the new ``TPU`` node (mesh shape, compute
dtype, sweep parallelism); everything else is shared surface.
"""

from __future__ import annotations

import os.path as op

from .cfg_node import CfgNode as CN

_C = CN()

_C.BASE = [""]
_C.NAME = ""
_C.DATA_DIR = ""
_C.DIST_BACKEND = "nccl"  # accepted for script compat; ignored (JAX collectives)
_C.GPUS = (0,)
_C.MULTIPROCESSING_DISTRIBUTED = True
_C.OUTPUT_DIR = ""
_C.PIN_MEMORY = True
_C.PRINT_FREQ = 20
_C.RANK = 0
_C.VERBOSE = True
_C.WORKERS = 4

_C.AMP = CN()
_C.AMP.ENABLED = False
_C.AMP.MEMORY_FORMAT = "nchw"

_C.CUDNN = CN()
_C.CUDNN.BENCHMARK = True
_C.CUDNN.DETERMINISTIC = False
_C.CUDNN.ENABLED = True

_C.MODEL = CN()
_C.MODEL.NAME = "cls_hrnet"
_C.MODEL.INIT_WEIGHTS = True
_C.MODEL.PRETRAINED = ""
_C.MODEL.NUM_PARAMS_IN_M = 0.0
_C.MODEL.AUTHOR = ""
_C.MODEL.PRETRAINED_DATA = ""
_C.MODEL.CREATION_TIME = ""
_C.MODEL.CLIP_FP32 = False
_C.MODEL.PRETRAINED_LAYERS = ["*"]
_C.MODEL.NUM_CLASSES = 1000
_C.MODEL.SPEC = CN(new_allowed=True)
_C.MODEL.SPEC.TEXT = CN(new_allowed=True)
_C.MODEL.SPEC.TEXT.CONTEXT_LENGTH = 77
_C.MODEL.STATS = CN(new_allowed=True)

_C.KNOWLEDGE = CN(new_allowed=True)
_C.KNOWLEDGE.WORDNET = CN(new_allowed=True)
_C.KNOWLEDGE.WORDNET.USE_HIERARCHY = False
_C.KNOWLEDGE.WORDNET.USE_DEFINITION = False
_C.KNOWLEDGE.WIKITIONARY = CN(new_allowed=True)
_C.KNOWLEDGE.WIKITIONARY.USE_DEFINITION = False
_C.KNOWLEDGE.WIKITIONARY.WIKI_DICT_PATH = "resources/knowledge/external"
_C.KNOWLEDGE.GPT3 = CN(new_allowed=True)
_C.KNOWLEDGE.GPT3.USE_GPT3 = False
_C.KNOWLEDGE.GPT3.GPT3_DICT_PATH = "resources/knowledge/gpt3"
_C.KNOWLEDGE.AGGREGATION = CN(new_allowed=True)
_C.KNOWLEDGE.AGGREGATION.MEHTOD = "WIKI_AND_GPT3"  # [sic] reference typo kept
_C.KNOWLEDGE.AGGREGATION.NUM_GPT3_ITEMS = 1

_C.LOSS = CN()
_C.LOSS.LABEL_SMOOTHING = 0.0
_C.LOSS.LOSS = "softmax"
_C.LOSS.FOCAL = CN()
_C.LOSS.FOCAL.NORMALIZE = True
_C.LOSS.FOCAL.ALPHA = 1.0
_C.LOSS.FOCAL.GAMMA = 0.5

_C.DATASET = CN(new_allowed=True)
_C.DATASET.ROOT = ""
_C.DATASET.DATASET = "imagenet"
_C.DATASET.IMAGE_SIZE = (224,)
_C.DATASET.CENTER_CROP = True
_C.DATASET.NUM_CLASSES = 0
_C.DATASET.TRAIN_SET = "train"
_C.DATASET.VAL_SET = ""
_C.DATASET.TEST_SET = "val"
_C.DATASET.DATA_FORMAT = "jpg"
_C.DATASET.LABELMAP = ""
_C.DATASET.TRAIN_TSV_LIST = []
_C.DATASET.TEST_TSV_LIST = []
_C.DATASET.COCO = CN(new_allowed=True)
_C.DATASET.COCO.SCALES = ["m", "l"]
_C.DATASET.COCO.BALANCE_DATA = True
_C.DATASET.ALLOW_SYNTHETIC = False  # TPU addition: real ELEVATER names fail loudly without local data unless this opts synthetic fallback in (smoke grid sets it)
_C.DATASET.NUM_SAMPLES_PER_CLASS = -1
_C.DATASET.RANDOM_SEED_SAMPLING = 0
_C.DATASET.MERGE_TRAIN_VAL_FINAL_RUN = True
_C.DATASET.TARGET_SIZE = -1

_C.INPUT = CN()
_C.INPUT.MEAN = [0.485, 0.456, 0.406]
_C.INPUT.STD = [0.229, 0.224, 0.225]

_C.AUG = CN()
_C.AUG.RANDOM_CENTER_CROP = False
_C.AUG.SCALE = (0.08, 1.0)
_C.AUG.RATIO = (3.0 / 4.0, 4.0 / 3.0)
_C.AUG.COLOR_JITTER = [0.4, 0.4, 0.4, 0.1, 0.0]
_C.AUG.GRAY_SCALE = 0.0
_C.AUG.GAUSSIAN_BLUR = 0.0
_C.AUG.DROPBLOCK_LAYERS = [3, 4]
_C.AUG.DROPBLOCK_KEEP_PROB = 1.0
_C.AUG.DROPBLOCK_BLOCK_SIZE = 7
_C.AUG.MIXUP_PROB = 0.0
_C.AUG.MIXUP = 0.0
_C.AUG.MIXCUT = 0.0
_C.AUG.MIXCUT_MINMAX = []
_C.AUG.MIXUP_SWITCH_PROB = 0.5
_C.AUG.MIXUP_MODE = "batch"
_C.AUG.MIXCUT_AND_MIXUP = False
_C.AUG.TIMM_AUG = CN(new_allowed=True)
_C.AUG.TIMM_AUG.USE_LOADER = False
_C.AUG.TIMM_AUG.USE_TRANSFORM = False

_C.SWA = CN()
_C.SWA.ENABLED = False
_C.SWA.DEVICE = "cpu"
_C.SWA.BEGIN_EPOCH = -1
_C.SWA.LR_RATIO = 0.5
_C.SWA.ANNEAL_EPOCHS = 10
_C.SWA.ANNEAL_STRATEGY = "cos"
_C.SWA.FROZEN_BN = False

_C.TRAIN = CN()
_C.TRAIN.AUTO_RESUME = True
_C.TRAIN.CHECKPOINT = ""
_C.TRAIN.LR_SCHEDULER = CN(new_allowed=True)
_C.TRAIN.SCHEDULE = []
_C.TRAIN.LR = 0.001
_C.TRAIN.SEARCH_WD_LOG_LOWER = -6
_C.TRAIN.SEARCH_WD_LOG_UPPER = 6
_C.TRAIN.FREEZE_IMAGE_BACKBONE = False
_C.TRAIN.TWO_LR = False
_C.TRAIN.USE_CHANNEL_BN = True
_C.TRAIN.INIT_HEAD_WITH_TEXT_ENCODER = False
_C.TRAIN.LOGIT_SCALE_INIT = "none"  # none | pretrained | ln_cls | clip
_C.TRAIN.TRAINABLE_LOGIT_SCALE = False
_C.TRAIN.MERGE_ENCODER_AND_HEAD_PROJ = False
_C.TRAIN.NORMALIZE_VISUAL_FEATURE = False
_C.TRAIN.SEARCH_RESULT_ON_LAST_EPOCH = False
_C.TRAIN.OPTIMIZER = "sgd"
_C.TRAIN.OPTIMIZER_ARGS = CN(new_allowed=True)
_C.TRAIN.MOMENTUM = 0.9
_C.TRAIN.WD = 0.0001
_C.TRAIN.WD_SEARCH_LEFT = False
_C.TRAIN.WITHOUT_WD_LIST = []
_C.TRAIN.NESTEROV = True
_C.TRAIN.GAMMA1 = 0.99
_C.TRAIN.GAMMA2 = 0.0
_C.TRAIN.BEGIN_EPOCH = 0
_C.TRAIN.END_EPOCH = 100
_C.TRAIN.EXTRA_FINAL_TRAIN_EPOCH = 0
_C.TRAIN.EMULATE_ZERO_SHOT = False
_C.TRAIN.IMAGE_SIZE = [224, 224]
_C.TRAIN.BATCH_SIZE_PER_GPU = 32
_C.TRAIN.SHUFFLE = True
_C.TRAIN.EMA_DECAY = 0.0
_C.TRAIN.EVAL_BEGIN_EPOCH = 0
_C.TRAIN.LARC = False
_C.TRAIN.DETECT_ANOMALY = False
_C.TRAIN.CLIP_GRAD_NORM = 0.0
_C.TRAIN.LOADER = "blobfuse"
_C.TRAIN.SAMPLER = "default"
_C.TRAIN.NUM_SAMPLES_CLASS = "average"
_C.TRAIN.SAVE_ALL_MODELS = False

_C.TEST = CN()
_C.TEST.BATCH_SIZE_PER_GPU = 32
_C.TEST.CENTER_CROP = True
_C.TEST.IMAGE_SIZE = [224, 224]
_C.TEST.INTERPOLATION = 2
_C.TEST.MODEL_FILE = ""
_C.TEST.REAL_LABELS = False
_C.TEST.VALID_LABELS = ""
_C.TEST.METRIC = ""

_C.FINETUNE = CN()
_C.FINETUNE.FINETUNE = False
_C.FINETUNE.USE_TRAIN_AUG = False
_C.FINETUNE.BASE_LR = 0.003
_C.FINETUNE.BATCH_SIZE = 512
_C.FINETUNE.EVAL_EVERY = 3000
_C.FINETUNE.FROZEN_LAYERS = []

_C.DEBUG = CN()
_C.DEBUG.DEBUG = False

_C.USE_DEEPSPEED = False
_C.DEEPSPEED = CN(new_allowed=True)

# --- TPU-native additions (not present in the reference) -------------------
_C.TPU = CN()
_C.TPU.COMPUTE_DTYPE = "bfloat16"   # activations/matmul dtype; params stay fp32
_C.TPU.PARITY_FP32 = False          # force fp32 everywhere (parity tests)
_C.TPU.MESH_DATA = -1               # batch-DP axis for the single-trial final run/eval: -1 auto (all leftover devices), 0/1 off, >1 cap (also enables trial x data hybrid); consumed by trainer._mesh_plan
_C.TPU.MESH_MODEL = 1               # tensor-parallel axis size (Megatron col/row specs on the frozen CLIP tree; consumed by trainer._mesh_plan)
_C.TPU.SWEEP_PARALLEL_TRIALS = 8    # max trials vmapped together PER DEVICE (r2: 8-wide measured 0.64 vs 1.03 s/trial at 4-wide; sweep._run_chunk halves the width automatically if a program exceeds the remote-compiler size limit)
_C.TPU.SWEEP_TRIALS_OVER_MESH = True  # shard the vmapped trial axis across devices (independent trials -> pure SPMD, no collectives)
_C.TPU.REMAT = False                # rematerialize transformer blocks (ViT-B fits without; enable for larger models/batches)
_C.TPU.SCAN_UNROLL = 0              # transformer layer-loop unroll: 0 full (default; measured +10% B/32 / +24% B/16 train), 1 rolled scan, k partial — consumed by TaskStatic.from_config / core.clip
_C.TPU.STEP_UNROLL = 1              # step-loop unroll: 1 fori_loop (default), k>1 scan(unroll=k) over train steps (cross-step fusion A/B) — consumed by TaskStatic.from_config / trainer.build_epoch_fn
_C.TPU.ATTN_LAYOUT = "auto"         # mask-free attention layout: auto (bhnd iff N<=64 — measured +4.5% B/32, crossover at N between 50 and 197), bnhd, bhnd; parity runs pin bnhd — consumed by TaskStatic.from_config / core.layers
_C.TPU.FAST_LN = False              # LayerNorm stats in activation dtype (speed; off = reference fp32 islands)
_C.TPU.FOLD_LN2 = False             # fold the ln_2 affine into the frozen c_fc GEMM (exact algebra; core/layers.py) — r4 A/B lever
_C.TPU.FAST_LN_SWEEP = False        # FAST_LN for SWEEP stages only (final run keeps fp32 LN); selection-equality gate: tools/fast_ln_gate.py
_C.TPU.USE_PALLAS_ATTENTION = False  # fused kernel available but XLA + transpose-free layout measured faster in-loop
_C.TPU.FUSED_MLP = False            # fused LN2->MLP->residual Pallas kernel (dgrad-only VJP; auto-disabled for full_finetune) — consumed by TaskStatic.from_config
_C.TPU.KADAPT_CONCAT_DELTA = False  # KAdaptation: one x@[H_q|H_v] (C,2C) GEMM per layer instead of two (C,C) GEMMs — exact algebra; measured -1.7% r5, stays opt-in (peft/kadaptation.py)
_C.TPU.MAX_DEVICE_DATA_GB = 4.0     # train splits above this stream from host RAM
_C.TPU.CHECKPOINT_DIR = ""          # orbax save/resume dir ('' = disabled)
_C.TPU.SWEEP_CACHE_DIR = "auto"     # sweep trial-score cache for crash/preemption resume: 'auto' = <run output dir>/sweep_cache (CLI), '' disables, else explicit dir — consumed by train/sweep_cache.py via sweep._run_stage
_C.TPU.SKIP_COMPLETED_JOBS = True   # campaign resume: a CLI job whose prediction artifact + fingerprint sidecar match skips training and replays the recorded result — consumed by commands/_common.run_training_command

_C.seal()


def get_default_config() -> CN:
    cfg = _C.clone()
    return cfg



def update_config(config, args) -> None:
    """Merge the YAML file ``args.cfg``, then the ``KEY VALUE`` overrides in
    ``args.opts``, as the reference's update_config
    (vision_benchmark/config/default.py:252-272): TRAIN.LR is scaled by the
    world size, NAME gains the file's stem, and a mixup/cutmix setting
    turns MIXUP_PROB on.  The world size is the reference's, its process
    count: one JAX process drives a host's chips, so the port, one process
    a card, multiplies by its hosts (``dist.host_count``), not its ranks,
    and a world on one host keeps TRAIN.LR as it is."""
    from ..utils import dist as comm

    config.defrost()
    config.merge_from_file(args.cfg)
    config.merge_from_list(getattr(args, "opts", []) or [])
    config.TRAIN.LR *= comm.host_count()
    file_name, _ = op.splitext(op.basename(args.cfg))
    config.NAME = file_name + config.NAME
    config.RANK = comm.rank()

    if "METHOD" in config.TRAIN.LR_SCHEDULER and config.TRAIN.LR_SCHEDULER.METHOD == "timm":
        config.TRAIN.LR_SCHEDULER.ARGS = config.TRAIN.LR_SCHEDULER.get("ARGS", {})

    aug = config.AUG
    if aug.MIXUP > 0.0 or aug.MIXCUT > 0.0 or aug.MIXCUT_MINMAX:
        aug.MIXUP_PROB = 1.0
    config.freeze()
