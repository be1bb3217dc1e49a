"""Default config tree.

The same keys and default values as the JAX package's tree
(`dual_space_nerf_tpu/config/defaults.py`), so every YAML under `configs/`
merges into both and dumps the same. Knobs that steer TPU-only code paths
(fused Pallas MLP, remat, listed/pruned searches) keep their keys here; the
port's renderer refuses the settings it does not implement rather than
ignoring them (see `renderer.pipeline.RenderSettings.from_cfg`).
"""

from .node import CfgNode as CN

_C = CN()

_C.MODEL = CN()
_C.MODEL.TYPE = "nerfW"
_C.MODEL.DEVICE = "tpu"
_C.MODEL.COARSE_RAY_SAMPLING = 64
_C.MODEL.FINE_RAY_SAMPLING = 64
_C.MODEL.SAMPLE_METHOD = "NEAR_FAR"
_C.MODEL.BOARDER_WEIGHT = 1e10
_C.MODEL.SAME_SPACENET = False
_C.MODEL.BACKBONE_DIM = 256

_C.MODEL.TKERNEL_INC_RAW = True
_C.MODEL.POSE_REFINEMENT = False

_C.MODEL.USE_DIR = True
_C.MODEL.perturb = 1.0
_C.MODEL.raw_noise_std = 1.0

_C.MODEL.BLENDING_SCHEME = "VOLUME RENDERING"
_C.MODEL.EMBED_TYPE = "POSITIONAL"
_C.MODEL.sample_points_mode = "uniform"  # "uniform" | "GG"
_C.MODEL.LOSS = "L2"  # 'L1', 'L2'
_C.MODEL.LOSSwMask = False

# --- runtime knobs (not in the reference) ------------------------------------
_C.MODEL.MAX_FRAMES = 500          # nn.Embedding(500, 8)
_C.MODEL.CODE_DIM = 8
_C.MODEL.MLP_CHUNK = -1            # points per network call; <= 0 = auto (renderer.resolve_mlp_chunk)
_C.MODEL.MATMUL_PRECISION = "f32"  # "f32" | "bf16"
_C.MODEL.KNN_IMPL = "auto"         # "auto" | "listed" | "pruned" | "pallas" | "xla" | "grouped" | "clustered"
_C.MODEL.REMAT = "auto"            # "auto" | True | False (JAX package only)
# Importance-gated shading: color only the top-K samples per ray. 0/-1 = off
# (shade all samples, reference-exact).
_C.MODEL.SHADE_TOPK = 0
# Reuse the world warp's face id for the normal transport instead of a
# second nearest-face search in canonical space. Approximation; off.
_C.MODEL.REUSE_WARP_FACES = False
# Fused SpaceNet kernels of the JAX package; "auto" resolves to off.
_C.MODEL.FUSED_MLP = "auto"
_C.MODEL.FUSED_BLOCK = 512
_C.MODEL.FUSED_FAST = False

# ----------------------------------------------------------------------------
# Dataset
# ----------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TYPE = "zju_mocap"  # zju_mocap | h36m | synthetic
_C.DATASETS.HUMAN = "CoreView_313"

# Overridable via env DSNERF_ZJU_PATH / DSNERF_H36M_PATH / DSNERF_SMPL_PATH
_C.DATASETS.ZJU_MOCAP_PATH = "data/zju_mocap"
_C.DATASETS.H36M_PATH = "data/h36m"
_C.DATASETS.SMPL_PATH = "data/smpl/SMPL_NEUTRAL.pkl"

# Asset-free synthetic scene (DATASETS.TYPE = "synthetic") scale knobs.
_C.DATASETS.SYNTHETIC_FRAMES = 2
_C.DATASETS.SYNTHETIC_VIEWS = 3
_C.DATASETS.SYNTHETIC_SIZE = 96
_C.DATASETS.SYNTHETIC_VAL_VIEW_OFFSET = 0.0

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 8
_C.DATALOADER.PREFETCH = 2
_C.DATALOADER.BACKEND = "thread"

# ----------------------------------------------------------------------------
# Solver
# ----------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.OPTIMIZER_NAME = "SGD"

_C.SOLVER.MAX_EPOCHS = 50

_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.BIAS_LR_FACTOR = 2

_C.SOLVER.MOMENTUM = 0.9

_C.SOLVER.WEIGHT_DECAY = 0.0005
_C.SOLVER.WEIGHT_DECAY_BIAS = 0.0

_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)

_C.SOLVER.WARMUP_FACTOR = 1.0 / 3
_C.SOLVER.WARMUP_ITERS = 500
_C.SOLVER.WARMUP_METHOD = "linear"

_C.SOLVER.CHECKPOINT_PERIOD = 10
_C.SOLVER.TEST_PERIOD = 1000
_C.SOLVER.LOG_PERIOD = 100
_C.SOLVER.BUNCH = 4096
_C.SOLVER.START_ITERS = 50
_C.SOLVER.END_ITERS = 200
_C.SOLVER.LR_SCALE = 0.1
_C.SOLVER.COARSE_STAGE = 10

_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.TRAIN_NRAYS = 5500       # rays per train step

_C.TEST = CN()
_C.TEST.IMS_PER_BATCH = 8
_C.TEST.WEIGHT = ""
_C.TEST.SAMPLE_NUMS = 100000
_C.TEST.STEP_SIZE = 1
_C.TEST.STEP_NUM = 2
_C.TEST.light_center = []
_C.TEST.RAY_CHUNK = 8192           # rays per eval render chunk
_C.TEST.LPIPS_WEIGHTS = ""

_C.OUTPUT_DIR = ""


def get_cfg_defaults() -> CN:
    """Return a fresh clone of the default config tree."""
    return _C.clone()
