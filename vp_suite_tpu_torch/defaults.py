r"""Package settings and the default run configuration (the JAX package's,
with the same keys and values).

``SETTINGS`` keeps the run path, below which the run artifacts (checkpoints,
data, logs) live, in the port's own ``resources/local_config.json``. The file
is read, or written with the default run path, the first time a path is
asked for, never when the module is imported.
"""
import dataclasses
import json
from pathlib import Path


class _PackageSettings:
    r"""Package-level constants and persistent paths."""

    PKG_ROOT_PATH = Path(__file__).parent.parent
    PKG_SRC_PATH = Path(__file__).parent
    PKG_RESOURCES = PKG_SRC_PATH / "resources"
    LOCAL_CONFIG_FP: str = str((PKG_RESOURCES / "local_config.json").resolve())
    DEFAULT_RUN_PATH = PKG_ROOT_PATH / "vp-suite-data"

    def __init__(self):
        self._run_path = None

    @property
    def RUN_PATH(self) -> Path:
        if self._run_path is None:
            try:
                with open(self.LOCAL_CONFIG_FP, "r") as f:
                    self._run_path = Path(json.load(f)["run_path"])
            except (FileNotFoundError, KeyError, json.JSONDecodeError):
                self._run_path = self.DEFAULT_RUN_PATH
                try:
                    self._persist()
                except OSError:
                    pass
        return self._run_path

    @property
    def OUT_PATH(self) -> Path:
        return self.RUN_PATH / "output"

    @property
    def DATA_PATH(self) -> Path:
        return self.RUN_PATH / "data"

    @property
    def LOG_PATH(self) -> Path:
        return self.RUN_PATH / "logs"

    def set_run_path(self, new_path):
        r"""Re-points the run path (and the paths below it) and persists the choice."""
        self._run_path = Path(new_path)
        self._persist()

    def _persist(self):
        self.PKG_RESOURCES.mkdir(parents=True, exist_ok=True)
        with open(self.LOCAL_CONFIG_FP, "w") as f:
            json.dump({"run_path": str(self._run_path.resolve())}, f)


@dataclasses.dataclass
class DefaultRunConfig:
    r"""Default run configuration; ``VPSuite.train`` takes each field as a
    keyword and rejects unknown ones. The keys are the JAX package's, its
    device and parallelism fields included (read for one process per device:
    ``vp_suite_tpu_torch.parallel``)."""
    no_train: bool = False
    no_val: bool = False
    no_vis: bool = False
    no_wandb: bool = False
    vis_every: int = 10
    n_vis: int = 5
    vis_mode: str = "gif"
    vis_compare: bool = False
    vis_context_frame_idx: int = None
    seed: int = 42                  #: run seed; also the parameter-init seed of ``create_model``
    lr: float = 0.0001              #: Adam's learning rate
    epochs: int = 1000000
    max_training_hours: float = 48
    batch_size: int = 32
    losses_and_scales: dict = dataclasses.field(default_factory=lambda: {"mse": 1.0})
    val_rec_criterion: str = "mse"
    metrics: list = dataclasses.field(default_factory=lambda: ["mse", "lpips", "psnr", "ssim"])
    context_frames: int = 10
    pred_frames: int = 10
    seq_step: int = 1
    use_actions: bool = False
    out_dir: str = None

    device: str = "auto"            #: replaced by the suite's device
    compute_dtype: str = None       #: None keeps the model's; "bfloat16" re-casts it for the run
    data_axis: str = "data"
    num_devices: int = 0            #: 0: the whole process group (one device without one); or 1
    fsdp: bool = False              #: shard large parameters and their moments over the group
    ckpt_backend: str = "msgpack"   #: "msgpack": one ``torch.save`` file; "orbax": sharded (DCP)
    accum_steps: int = 1            #: microbatches per optimizer step
    multihost: bool = False         #: join the process group (torchrun's variables) first
    prefetch_batches: int = 2       #: host-to-device pipeline depth
    hbm_cache: str = "auto"
    hbm_cache_mb: int = 2048
    steps_per_epoch: int = 0        #: 0 = a full pass over the training set
    val_batch_size: int = 0         #: 0 = batch_size
    log_every: int = 50             #: logging cadence (steps)
    profile_dir: str = None         #: a torch.profiler Chrome trace of epoch 2's training loop


SETTINGS = _PackageSettings()
DEFAULT_RUN_CONFIG = dataclasses.asdict(DefaultRunConfig())
