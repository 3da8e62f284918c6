r"""The VPSuite facade of the port: datasets, model creation and loading,
training, testing and direct inference.

The JAX package's ``VPSuite`` semantics: ``load_dataset`` wraps a registry
dataset into train/val (or test) splits; ``create_model`` takes REQUIRED_ARGS
missing from its keywords from the last loaded dataset; ``train`` runs the
epochs with the JAX package's control flow (run config over the defaults,
unknown keywords refused, strict compatibility checks, a seeded shuffling
host loader, a file-backed set staged in the card's memory (``hbm_cache``)
or, for on-the-fly Moving MNIST with ``backend="device"``, batches made on
the card, validation through the host loader or the staged set,
ReduceLROnPlateau, best and final checkpoints, ``metrics.jsonl``);
``load_model`` rebuilds a checkpointed model; ``test`` runs every loaded
model and the CopyLastFrame baseline over each test set, batch by batch, and
reports every measure for each prediction horizon (``test_metrics.jsonl``
and ``test_metrics.json``); ``predict`` accepts a single
``[t, h, w, c]`` sequence, zero-fills absent actions and caches the predictor
per ``(context, horizon, action_conditional)``. Models run on CUDA unless the
caller asks for the CPU.

The tooling: ``train`` and ``test`` write visualisations unless ``no_vis``
(``utils/visualization.py``: GIFs every ``vis_every`` epochs of training,
and per tested model, with comparison PNGs under ``vis_compare``);
``train(trial=...)`` applies a hyperopt trial's suggestions and
``hyperopt`` runs a study (optuna's where installed, else the port's
``TPEStudy``); ``profile_dir`` records a ``torch.profiler`` Chrome trace of
the second epoch's training loop; ``export_model`` writes a ``torch.export``
program (``serving/``); ``load_torch_model`` imports a checkpoint of the
reference vp-suite (``utils/torch_import.py``); ``download_dataset`` calls
the dataset's download.

Parallel training runs one process per device (``parallel/``): start them
with ``torchrun --nproc-per-node N`` and train with ``multihost=True`` (or
join them first with ``parallel.initialize_multihost()``, then build the
suite). Each process trains on its shard of the data at its share of the
batch, the gradients are averaged over the group, ``fsdp=True`` shards the
large parameters and their Adam moments over it, and ``ckpt_backend="orbax"``
writes the sharded checkpoint (``checkpoint/orbax_backend.py``), which
``load_model`` reads as it reads the other. ``num_devices`` is 0 (the whole
group, or one device without a group) or 1.

The steps are compiled where the JAX facade jits them (``use_jit=True`` of
the step builders, ``training/graphs.py``): on the card ``train``'s train,
eval and predict steps, ``test``'s predictors and ``predict``'s cached
functions each run their first call of a batch shape eagerly, capture the
second into a CUDA graph and replay it from then on. ``train`` builds them
with ``use_jit=False`` in a process group (the port does not capture
collectives) and with an FVD loss (FVD reads back to the host).
"""
import itertools
import json
import os
import random
import time
import warnings
from copy import deepcopy
from pathlib import Path

import numpy as np
import torch

from vp_suite_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from vp_suite_tpu_torch.datasets import DATASET_CLASSES
from vp_suite_tpu_torch.defaults import DEFAULT_RUN_CONFIG, SETTINGS
from vp_suite_tpu_torch.measure import LOSS_CLASSES
from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
from vp_suite_tpu_torch.measure.metric_provider import PredictionMetricProvider
from vp_suite_tpu_torch.models import AVAILABLE_MODELS, MODEL_CLASSES, build_model
from vp_suite_tpu_torch.parallel.distributed import (initialize_multihost, is_grouped,
                                                     local_batch_size, process_count,
                                                     process_index, shard_dataset_for_process)
from vp_suite_tpu_torch.parallel.mesh import (is_fsdp, make_mesh, mean_over, shard_params,
                                              shard_params_fsdp)
from vp_suite_tpu_torch.training.data import (BatchLoader, HBMCachedLoader, device_prefetch,
                                             estimate_cache_bytes)
from vp_suite_tpu_torch.training.loop import make_eval_step, make_predict_fn, make_train_step
from vp_suite_tpu_torch.training.schedule import ReduceLROnPlateau, set_learning_rate
from vp_suite_tpu_torch.training.train_state import create_train_state, rebuild_optimizer
from vp_suite_tpu_torch.utils.compatibility import (AdapterChain, check_model_and_data_compat,
                                                    check_run_and_model_compat)
from vp_suite_tpu_torch.utils.dataset_wrapper import VPDatasetWrapper
from vp_suite_tpu_torch.utils.utils import (check_optuna_config, resolve_device, timestamp,
                                            torch_dtype)
from vp_suite_tpu_torch.utils.visualization import (get_vis_from_model, visualize_sequences,
                                                    visualize_vid)


class ModelEntry:
    r"""A created or loaded model (an ``nn.Module`` on the suite's device)
    with its registry id, its training state (created by the first ``train``
    or loaded with the checkpoint, then kept), the directory it is saved in
    and its cached predictors."""

    def __init__(self, model, model_id, state=None, model_dir=None):
        self.model = model
        self.model_id = model_id
        self.state = state
        self.model_dir = model_dir
        self.predict_fns = {}
        self.train_epoch_fps = []   #: frames/s of each epoch of the last ``train``

    @property
    def NAME(self):
        return self.model.NAME

    @property
    def config(self):
        return self.model.config


class VPSuite:
    def __init__(self, device: str = "cuda"):
        r"""device: ``"cuda"`` (default; the current card), ``"cuda:N"`` or
        ``"cpu"``. Raises when a CUDA device is asked for and none is
        available: the CPU runs only when the caller asks for it."""
        self.device = resolve_device(device, "VPSuite")
        self.clear_models()
        self.clear_datasets()

    # ------------------------------------------------------------------ #
    # datasets and models
    @property
    def training_sets(self):
        return [d for d in self.datasets if d.is_training_set]

    @property
    def test_sets(self):
        return [d for d in self.datasets if d.is_test_set]

    def clear_datasets(self):
        self.datasets = []

    def clear_models(self):
        self.models = []

    def load_dataset(self, dataset_id: str, split: str = "train", **dataset_kwargs):
        r"""Loads a registry dataset (its train and val splits, or its test
        split) and appends it to the suite's datasets; ``context_frames``,
        ``pred_frames`` and ``seq_step`` among the keywords set its sequence
        length."""
        dataset_class = DATASET_CLASSES[dataset_id]
        seq_kwargs = {k: dataset_kwargs.pop(k) for k in
                      ["context_frames", "pred_frames", "seq_step"] if k in dataset_kwargs}
        dataset = VPDatasetWrapper(dataset_class, split, **dataset_kwargs)
        print(f"loaded dataset '{dataset.NAME}' (action size: {dataset.action_size})")
        if seq_kwargs:
            dataset.set_seq_len(
                seq_kwargs.get("context_frames", DEFAULT_RUN_CONFIG["context_frames"]),
                seq_kwargs.get("pred_frames", DEFAULT_RUN_CONFIG["pred_frames"]),
                seq_kwargs.get("seq_step", DEFAULT_RUN_CONFIG["seq_step"]))
        self.datasets.append(dataset)
        return dataset

    def download_dataset(self, dataset_id: str):
        r"""Runs the registry dataset's ``download_and_prepare_dataset``."""
        DATASET_CLASSES[dataset_id].download_and_prepare_dataset()

    def list_available_datasets(self):
        for dataset_id, dataset_class in DATASET_CLASSES.items():
            print(f"'{dataset_id}': {dataset_class.NAME}")

    def list_available_models(self):
        for model_id, model_class in MODEL_CLASSES.items():
            print(f"'{model_id}': {model_class.NAME}")

    def load_model(self, model_dir: str, ckpt_name: str = "best_model"):
        r"""Rebuilds a checkpointed model (``model_dir/ckpt_name``, as
        ``train`` saves them) on the suite's device, with its training state;
        appends it to the suite's models and returns its :class:`ModelEntry`."""
        ckpt_dir = Path(model_dir) / ckpt_name if ckpt_name else Path(model_dir)
        model, state, model_id = load_checkpoint(ckpt_dir, self.device)
        entry = ModelEntry(model.eval(), model_id, state=state, model_dir=str(model_dir))
        self._model_setup(entry, loaded=True)
        return entry

    def load_torch_model(self, model_dir: str, ckpt_name: str = "best_model.pth",
                         seed: int = None):
        r"""Imports a checkpoint trained with the reference vp-suite (a
        pickled module, ``model_dir/ckpt_name``; unpickling needs the reference
        package importable) into the port's model of the same registry id,
        on the suite's device, with a fresh training state (Adam at the run
        default ``lr``, the generator from ``seed``); appends it to the
        suite's models and returns its :class:`ModelEntry`. The reference's
        LSTM keeps its cells out of its ``state_dict`` (and never trained
        them): the port keeps its fresh cells for them. See
        :mod:`vp_suite_tpu_torch.utils.torch_import` for the state-dict path,
        which needs no reference package."""
        from vp_suite_tpu_torch.utils.torch_import import load_torch_checkpoint, model_from_import
        ckpt = os.path.join(model_dir, ckpt_name) if ckpt_name else model_dir
        seed = DEFAULT_RUN_CONFIG["seed"] if seed is None else seed
        model_id, model_kwargs, state_dict = load_torch_checkpoint(ckpt)
        model = model_from_import(model_id, model_kwargs, state_dict, self.device, seed)
        state = create_train_state(model, lr=DEFAULT_RUN_CONFIG["lr"], seed=seed)
        entry = ModelEntry(model.eval(), model_id, state=state, model_dir=str(model_dir))
        self._model_setup(entry, loaded=True)
        return entry

    def create_model(self, model_id: str, action_conditional: bool = False,
                     seed: int = None, **model_kwargs):
        r"""Creates a registry model, taking REQUIRED_ARGS missing from
        ``model_kwargs`` from the last loaded dataset, with parameters drawn
        from a ``torch.Generator`` seeded with ``seed`` (default 42) on the
        CPU, then moved to the suite's device; returns its :class:`ModelEntry`."""
        if model_id not in AVAILABLE_MODELS:
            raise ValueError(f"invalid model type specified! "
                             f"Available model types: {list(AVAILABLE_MODELS)}")
        model_class = MODEL_CLASSES[model_id]
        for param in model_class.REQUIRED_ARGS:
            if param not in model_kwargs:
                print(f"model parameter '{param}' not specified "
                      f"-> trying to take from last loaded dataset...")
                if len(self.datasets) < 1:
                    raise ValueError(f"no dataset loaded to take parameter '{param}' from")
                param_val = self.datasets[-1].config.get(param, None)
                if param_val is None:
                    raise ValueError(f"dataset '{self.datasets[-1].NAME}' doesn't provide "
                                     f"parameter '{param}', so it has to be specified "
                                     f"on model creation")
                model_kwargs[param] = param_val
        if action_conditional and not model_class.CAN_HANDLE_ACTIONS:
            warnings.warn("specified model can't handle actions "
                          "-> argument 'action_conditional' set to False")
            action_conditional = False
        model_kwargs["action_conditional"] = action_conditional
        for k, v in list(model_kwargs.items()):
            if isinstance(v, list):
                model_kwargs[k] = tuple(v)

        seed = DEFAULT_RUN_CONFIG["seed"] if seed is None else seed
        entry = ModelEntry(build_model(model_id, seed, self.device, **model_kwargs), model_id)
        self._model_setup(entry)
        return entry

    def _model_setup(self, entry: ModelEntry, loaded: bool = False):
        ac_str = "(action-conditional)" if entry.config["action_conditional"] else ""
        print(f"{'loaded' if loaded else 'created new'} model '{entry.NAME}' {ac_str}")
        print(f" - Model parameters (total): {sum(p.numel() for p in entry.model.parameters())}")
        self.models.append(entry)

    # ------------------------------------------------------------------ #
    # run preparation
    def _prepare_run(self, split: str = "train", **run_kwargs):
        if len(self.models) == 0:
            raise RuntimeError("No model available. Load a pretrained model or create a "
                               "new instance before starting training or test runs")
        if split == "train" and len(self.training_sets) == 0:
            raise ValueError("No training sets loaded. Load a dataset in training mode "
                             "before starting training or test runs")
        elif split == "test" and len(self.test_sets) == 0:
            raise ValueError("No test sets loaded. Load a dataset in test mode "
                             "before starting training or test runs")
        run_config = deepcopy(DEFAULT_RUN_CONFIG)
        optuna_config = run_kwargs.pop("optuna", None)   # a hyperopt search space rides along
        unknown = [k for k in run_kwargs if k not in run_config]
        if unknown:
            raise ValueError(f"Only the following run arguments are supported: "
                             f"{list(run_config.keys())} (got unknown: {unknown})")
        run_config.update(run_kwargs)
        if optuna_config is not None:
            run_config["optuna"] = optuna_config
        _check_devices(run_config, split)
        self._set_seeds(run_config["seed"])
        run_config["opt_direction"] = "maximize" \
            if LOSS_CLASSES[run_config["val_rec_criterion"]].BIGGER_IS_BETTER else "minimize"
        run_config["device"] = str(self.device)
        return run_config

    def _set_seeds(self, seed: int):
        r"""The single seeding site: Python's and numpy's global RNGs, and a
        root ``torch.Generator`` from which randomness of the suite's own is
        drawn (torch's global RNG is left alone)."""
        random.seed(seed)
        np.random.seed(seed)
        self._root_rng = torch.Generator().manual_seed(seed)

    def reset_rng(self, seed: int):
        self._set_seeds(seed)
        for dataset in self.datasets:
            dataset.reset_rng()

    # ------------------------------------------------------------------ #
    # training
    def _prepare_training(self, dataset_idx: int, model_idx: int, **run_kwargs):
        run_config = self._prepare_run("train", **run_kwargs)
        try:
            dataset = self.training_sets[dataset_idx]
            entry = self.models[model_idx]
        except IndexError:
            raise ValueError("given indices for model and/or dataset are invalid")
        dataset.set_seq_len(run_config["context_frames"], run_config["pred_frames"],
                            run_config["seq_step"])
        if not dataset.is_ready():
            raise RuntimeError("dataset is not ready even though set_seq_len was called")
        check_run_and_model_compat(entry.model, run_config)
        check_model_and_data_compat(entry.model, dataset, strict_mode=True)
        return entry, dataset, run_config

    def _data_mesh(self, model, run_config):
        r"""The data mesh of a ``train`` run (None for one device): with
        ``multihost`` this process first joins the process group (its
        variables from torchrun). In a group the mesh is the whole group, the
        global batch must divide by its size, ``num_devices`` must be 0, and
        the model must lie on this process's device (``cuda:LOCAL_RANK``)."""
        if run_config["multihost"]:
            initialize_multihost(device=self.device.type)
        if not is_grouped():
            return make_mesh(run_config["num_devices"], run_config["data_axis"])
        if run_config["num_devices"]:
            raise ValueError("num_devices cannot be set in multi-host mode "
                             "(the mesh spans all hosts' devices)")
        world, batch_size = process_count(), run_config["batch_size"]
        if batch_size % world != 0:
            raise ValueError(f"global batch_size {batch_size} not divisible "
                             f"by {world} global devices")
        want = torch.device("cuda", torch.cuda.current_device()) \
            if self.device.type == "cuda" else torch.device("cpu")
        found = next(model.parameters(), torch.empty(0, device=self.device)).device
        if found != want:
            raise ValueError(f"process {process_index()} runs on {want}, but the model lies on "
                             f"{found}: build the VPSuite after initialize_multihost(), which "
                             f"binds each process's card")
        return make_mesh(0, run_config["data_axis"], self.device.type)

    def train(self, trial=None, dataset_idx: int = -1, model_idx: int = -1, **run_kwargs):
        r"""Trains a loaded model on a loaded training set; returns the best
        validation indicator. Frames per second of each epoch's training
        loop (steps x batch x frames over its wall time) are kept in the
        entry's ``train_epoch_fps``. With a hyperopt ``trial`` and an
        ``optuna`` search space among the keywords (as :meth:`hyperopt`
        passes them), the trial's suggestions replace those run options.
        Unless ``no_vis``, every ``vis_every`` epochs writes videos of
        ``n_vis`` validation items to ``vis_ep_{NNN}/`` in the run directory;
        with ``profile_dir``, the second epoch's training loop is recorded by
        ``torch.profiler`` into a Chrome trace (``*.json``) there.

        In a process group (``multihost=True``, or one joined before) each
        process trains on its :class:`~vp_suite_tpu_torch.parallel.ProcessShard`
        of the data at ``batch_size / world`` per step, and the step is the
        global batch's (``make_train_step``'s ``mesh``); ``fsdp=True``
        shards the large parameters and their optimizer state over the group.
        Validation losses are averaged over the group, so every process takes
        the same learning-rate and best-model decisions. Rank 0 alone writes
        ``run_cfg.json``, the logs, the visualisations and the profile, and
        every process takes part in each checkpoint. The card-made batches
        and the device-memory cache stay off in a group of more than one
        process. Build the suite after ``initialize_multihost``: the model
        must lie on the process's own card.

        On one card without a group the steps are captured into CUDA graphs
        (``use_jit=True``): each batch shape's first step runs eagerly, its
        second is captured and replayed. In a group, or with ``"fvd"`` among
        the losses, they run eagerly (``use_jit=False``)."""
        entry, dataset, run_config = self._prepare_training(dataset_idx, model_idx,
                                                            **run_kwargs)
        model = entry.model
        mesh = self._data_mesh(model, run_config)
        world, is_main = process_count(), process_index() == 0
        say = print if is_main else _silent

        # the run's compute dtype re-casts the model's activations (the
        # parameters stay f32, so the training state stays valid)
        run_dtype = run_config.get("compute_dtype")
        if run_dtype and model.TRAINABLE:
            dtype = torch_dtype(run_dtype)
            if dtype != model.compute_dtype:
                model.compute_dtype = dtype
                say(f"run compute_dtype={str(dtype).removeprefix('torch.')}: "
                    f"the model runs its activations in it")
        optuna_config = run_config.get("optuna")
        if trial is not None and isinstance(optuna_config, dict):
            _apply_suggestions(trial, optuna_config, run_config, model.NAME)
        train_data, val_data = dataset.train_data, dataset.val_data
        batch_size = local_bs = run_config["batch_size"]
        if world > 1:
            train_data = shard_dataset_for_process(train_data)
            val_data = shard_dataset_for_process(val_data)
            local_bs = local_batch_size(batch_size)
            print(f"multi-host training: process {process_index()} of {world}, "
                  f"local batch {local_bs}")

        if run_config["out_dir"] is None and entry.model_dir is not None:
            say(f"Using existing model save location ({entry.model_dir})...")
            out_path = Path(entry.model_dir)
        else:
            out_path = Path(run_config["out_dir"] or SETTINGS.OUT_PATH / timestamp("train"))
            out_path.mkdir(parents=True, exist_ok=True)
            entry.model_dir = str(out_path.resolve())

        with_training = model.TRAINABLE and not run_config["no_train"]
        with_validation = not run_config["no_val"]

        config = {**run_config, **model.config, **dataset.config,
                  "model_name": model.NAME, "dataset_name": dataset.NAME}
        save_config = {"run": run_config, "model": model.config,
                       "dataset": dataset.config, "device": str(self.device)}
        if is_main:
            with open(out_path / "run_cfg.json", "w") as cfg_file:
                json.dump(save_config, cfg_file, indent=4, default=str)
        logger = _RunLogger(out_path, config, run_config["no_wandb"],
                            project="vp-suite-training") if is_main else _NullLogger()

        if run_config["accum_steps"] > 1 and local_bs % run_config["accum_steps"] != 0:
            raise ValueError(
                f"per-device batch {local_bs} not divisible by accum_steps "
                f"{run_config['accum_steps']}: the interleaved microbatch split would reshard "
                f"the batch every step")
        if world > 1:
            say(f"data-parallel training over {world} devices")

        # the state is built over the parameters as they are sharded
        if mesh is not None and not is_fsdp(model):
            shard_params(model, mesh)
            if run_config["fsdp"] and world > 1:
                shard_params_fsdp(model, mesh)
                if entry.state is not None:
                    rebuild_optimizer(entry.state)
        if entry.state is None:
            entry.state = create_train_state(model, lr=run_config["lr"], seed=run_config["seed"])
        state = set_learning_rate(entry.state, run_config["lr"])

        def save(path):   # every process: both backends are collective in a group
            if run_config["ckpt_backend"] == "orbax":
                from vp_suite_tpu_torch.checkpoint.orbax_backend import save_checkpoint_orbax
                save_checkpoint_orbax(path, state, entry.model_id, model.config, run_config)
            else:
                save_checkpoint(path, state, entry.model_id, model.config, run_config)

        loss_provider = PredictionLossProvider(config)
        if config["val_rec_criterion"] not in config["losses_and_scales"]:
            raise ValueError(f"Validation criterion '{config['val_rec_criterion']}' has "
                             f"to be one of the chosen losses: "
                             f"{list(config['losses_and_scales'].keys())}")
        # the compiled steps, as the JAX facade always asks for them; not on a
        # mesh (collectives are not captured) or with an FVD loss (it reads back)
        use_jit = mesh is None and "fvd" not in loss_provider.losses
        train_step = make_train_step(model, run_config, loss_provider,
                                     accum_steps=run_config["accum_steps"], mesh=mesh,
                                     use_jit=use_jit)
        eval_step = make_eval_step(model, run_config, loss_provider, use_jit=use_jit)
        predict_fn = make_predict_fn(model, run_config, use_jit=use_jit)
        entry.predict_fns.clear()   # the run may re-cast or re-shard the model
        profile_dir = run_config["profile_dir"]

        # uint8 host-to-device copies are exact up to 1/510 for [0, 1] data
        uint8_ok = [float(v) for v in dataset.config["tensor_value_range"]] == [0.0, 1.0]
        if len(train_data) < local_bs:
            raise ValueError(
                f"training set has {len(train_data)} sequences but batch_size is {local_bs}: "
                f"with drop_last no batch would ever be formed — lower batch_size or provide "
                f"more data")
        train_loader = BatchLoader(train_data, local_bs, shuffle=True, seed=run_config["seed"],
                                   drop_last=True, uint8_frames=uint8_ok)
        val_bs = run_config.get("val_batch_size", 0) or local_bs
        val_bs = max(1, min(val_bs, len(val_data)))
        val_loader = BatchLoader(val_data, batch_size=val_bs, shuffle=False, drop_last=True,
                                 uint8_frames=uint8_ok)
        # a group of processes keeps to the host loader of its shards
        train_cache, val_cache = self._stage_caches(
            run_config, train_data, val_data, local_bs, val_bs, uint8_ok,
            with_training and world == 1)

        scheduler = ReduceLROnPlateau(
            run_config["lr"], mode="max" if run_config["opt_direction"] == "maximize" else "min")
        best_val_loss = float("-inf") if run_config["opt_direction"] == "maximize" \
            else float("inf")

        def loss_improved(cur, best):
            return cur > best if run_config["opt_direction"] == "maximize" else cur < best

        steps_cap = run_config.get("steps_per_epoch", 0)
        # the device backend makes each training batch on the card from a
        # seeded generator; validation still goes through the host loader
        use_device_gen = (getattr(train_data, "backend", None) == "device"
                          and hasattr(train_data, "device_batch_iterator") and world == 1)
        training_timeout = time.time() + config["max_training_hours"] * 3600
        entry.train_epoch_fps = []
        for epoch in range(run_config["epochs"]):
            say(f"\nEpoch: {epoch + 1} of {config['epochs']}")

            if with_training:
                t0 = time.time()
                n_steps = 0
                profiler = _start_profiler(self.device) \
                    if profile_dir and epoch == 1 and is_main else None
                if use_device_gen:
                    batches = train_data.device_batch_iterator(
                        batch_size, steps_cap or len(train_loader),
                        seed=run_config["seed"] * 9973 + epoch, device=self.device)
                elif train_cache is not None:
                    batches = train_cache.epoch_iterator(seed=run_config["seed"] * 9973 + epoch)
                else:
                    batches = device_prefetch(train_loader, self.device,
                                              depth=run_config["prefetch_batches"])
                for device_batch in batches:
                    state, metrics = train_step(state, device_batch, epoch)
                    n_steps += 1
                    if n_steps % run_config["log_every"] == 0:
                        say(f"  step {n_steps}: {({k: float(v) for k, v in metrics.items()})}")
                    if steps_cap and n_steps >= steps_cap:
                        break
                if n_steps:
                    float(metrics["total"])   # waits for the device
                if profiler is not None:
                    _stop_profiler(profiler, profile_dir, epoch)
                dt = time.time() - t0
                frames_seen = n_steps * batch_size * (run_config["context_frames"]
                                                      + run_config["pred_frames"])
                entry.train_epoch_fps.append(frames_seen / max(dt, 1e-9))
                say(f"  trained {n_steps} steps in {dt:.1f}s "
                    f"({entry.train_epoch_fps[-1]:.1f} frames/s)")
            else:
                say("Skipping training loop.")

            val_losses = {}
            if with_validation:
                val_batches = val_cache.epoch_iterator(seed=0, shuffle=False) \
                    if val_cache is not None else device_prefetch(val_loader, self.device, depth=1)
                agg = [eval_step(state, batch) for batch in val_batches]
                if not agg:
                    raise RuntimeError("validation set is empty")
                # the mean over the shards: every process decides alike
                val_losses = mean_over({k: float(np.mean([float(a[k]) for a in agg]))
                                        for k in agg[0].keys()}, mesh)
                indicator_loss = val_losses[run_config["val_rec_criterion"]]
                if with_training:
                    state = set_learning_rate(state, scheduler.step(indicator_loss))
                say("Validation losses (mean over entire validation set):")
                for k, v in val_losses.items():
                    say(f" - {k}: {v}")
                if loss_improved(indicator_loss, best_val_loss):
                    best_val_loss = indicator_loss
                    save(out_path / "best_model")
                    say(f"Minimum indicator loss ({config['val_rec_criterion']}) "
                        f"reduced -> model saved!")
            else:
                say("Skipping validation loop and simply saving current model "
                    "as the 'best' model.")
                save(out_path / "best_model")

            if (epoch + 1) % config["vis_every"] == 0 and not config["no_vis"]:
                say("Saving visualizations...")
                if is_main:
                    visualize_vid(val_data, config["context_frames"], config["pred_frames"],
                                  predict_fn, out_path / f"vis_ep_{epoch + 1:03d}",
                                  n_vis=config["n_vis"], vis_mode=config["vis_mode"],
                                  device=self.device)
                elif is_fsdp(model):   # the sharded forward gathers on every process
                    for i in range(min(config["n_vis"], len(val_data))):
                        get_vis_from_model(val_data, val_data[i], predict_fn,
                                           config["context_frames"], self.device)

            logger.log_epoch(epoch, val_losses)
            if time.time() > training_timeout:
                say("Maximum training time exceeded, leaving training loop...")
                break

        say("\nTraining done, cleaning up...")
        entry.state = state
        save(out_path / "final_model")
        logger.finish()
        return best_val_loss

    def _stage_caches(self, run_config, train_data, val_data, batch_size, val_bs, uint8_ok,
                      with_training):
        r"""``(train cache, val cache)``: :class:`HBMCachedLoader` s of the
        training and validation sets, or None. ``hbm_cache="auto"`` stages the
        training set when :func:`estimate_cache_bytes` is within
        ``hbm_cache_mb``, ``"on"`` raises when it is not, ``"off"`` stages
        nothing; on-the-fly datasets, which make new sequences at each read,
        are never staged. The validation set is staged within what is left of
        the budget."""
        mode = run_config["hbm_cache"]
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"hbm_cache must be 'auto', 'on' or 'off', not '{mode}'")
        if mode == "off" or not with_training or getattr(train_data, "ON_THE_FLY", False):
            return None, None
        budget = run_config["hbm_cache_mb"] * 2 ** 20
        est = estimate_cache_bytes(train_data, uint8_ok)
        if est > budget:
            if mode == "on":
                raise ValueError(
                    f"hbm_cache='on' but the training set needs ~{est / 2**20:.0f} MB > "
                    f"hbm_cache_mb={run_config['hbm_cache_mb']} — raise the budget or use "
                    f"hbm_cache='auto'/'off'")
            return None, None
        train_cache = HBMCachedLoader(train_data, batch_size, self.device, uint8_frames=uint8_ok)
        print(f"staged training set into device memory ({train_cache.nbytes / 2**20:.1f} MB, "
              f"{train_cache.n} sequences)")
        val_cache = None
        if len(val_data) and estimate_cache_bytes(val_data, uint8_ok) \
                <= budget - train_cache.nbytes:
            val_cache = HBMCachedLoader(val_data, val_bs, self.device, uint8_frames=uint8_ok)
        return train_cache, val_cache

    # ------------------------------------------------------------------ #
    # hyperparameter optimization
    def hyperopt(self, optuna_config: dict, n_trials: int = 30, dataset_idx: int = -1,
                 model_idx: int = -1, **run_kwargs):
        r"""Runs ``n_trials`` trainings, each with a trial's suggestions from
        the search space ``optuna_config`` (see
        :func:`~vp_suite_tpu_torch.utils.utils.check_optuna_config`), in an
        optuna study where optuna is installed and else in the port's
        :class:`~vp_suite_tpu_torch.training.hyperopt.TPEStudy` (seeded with
        the run's ``seed``); each trial's value is ``train``'s best
        validation indicator, optimized in the direction of the validation
        criterion. Returns the best trial's parameters."""
        from functools import partial
        run_config = self._prepare_run(**run_kwargs)
        check_optuna_config(optuna_config)
        program = partial(self.train, dataset_idx=dataset_idx, model_idx=model_idx,
                          optuna=optuna_config, **run_kwargs)
        try:
            import optuna
            study = optuna.create_study(direction=run_config["opt_direction"])
        except (ImportError, AttributeError):
            from vp_suite_tpu_torch.training.hyperopt import TPEStudy
            study = TPEStudy(direction=run_config["opt_direction"], seed=run_config["seed"])
        study.optimize(program, n_trials=n_trials)
        best_params = study.best_params
        print("\nHyperparameter optimization complete. Best performing parameters:")
        for k, v in best_params.items():
            print(f" - {k}: {v}")
        return best_params

    # ------------------------------------------------------------------ #
    # testing
    def _prepare_testing(self, **run_kwargs):
        r"""The run configuration, and for each test set the models to test
        on it, as ``(entry, pre, post, metrics per batch)``: each loaded
        model that is compatible with the run and the data, then a
        CopyLastFrame baseline."""
        run_config = self._prepare_run("test", **run_kwargs)
        for test_set in self.test_sets:
            test_set.set_seq_len(run_config["context_frames"], run_config["pred_frames"],
                                 run_config["seq_step"])
            if not test_set.is_ready():
                raise RuntimeError("test set is not ready even though set_seq_len was called")

        test_entries = []
        for entry in self.models:
            try:
                check_run_and_model_compat(entry.model, run_config)
                test_entries.append(entry)
            except ValueError as e:
                print(f"skipping test of model '{entry.NAME}' because of incompatibility "
                      f"with run config: {e}")

        model_lists = []
        for test_set in self.test_sets:
            model_list = []
            for entry in test_entries:
                try:
                    pre, post = check_model_and_data_compat(entry.model, test_set)
                    model_list.append((entry, pre, post, []))
                except ValueError as e:
                    print(f"skipping test of model '{entry.NAME}' on dataset "
                          f"'{test_set.NAME}' because of incompatibility: {e}")
            clf = build_model("copy", 0, self.device, img_shape=tuple(test_set.config["img_shape"]),
                              action_size=0,
                              tensor_value_range=tuple(test_set.config["tensor_value_range"]))
            clf_entry = ModelEntry(clf, "copy", state=create_train_state(clf))
            model_list.append((clf_entry, AdapterChain(), AdapterChain(), []))
            model_lists.append(model_list)
        return list(zip(self.test_sets, model_lists)), run_config

    def _test_on_dataset(self, model_info_list, dataset, run_config, brief_test):
        r"""Runs each model over the test set's first batches (one sequence
        each, in order: at most 10 for a brief test, else all of them) and
        returns ``{model NAME: [metrics of horizon 1, ..., of pred_frames]}``,
        each the mean over the batches."""
        test_data = dataset.test_data
        test_loader = BatchLoader(test_data, batch_size=1, shuffle=False)
        if len(test_loader) < 1:
            raise RuntimeError("loaded dataset does not contain any data (len < 1)")
        test_mode = "brief" if brief_test else "full"
        eval_length = min(len(test_loader), 10) if brief_test else len(test_loader)

        config = {**run_config, **dataset.config, "dataset_name": dataset.NAME}
        cfg = {"context_frames": config["context_frames"], "pred_frames": config["pred_frames"]}
        metric_provider = PredictionMetricProvider(config)
        predictors = [make_predict_fn(entry.model, cfg, pre=pre, post=post)
                      for (entry, pre, post, _) in model_info_list]

        batches = iter(test_loader)
        for batch in itertools.islice(batches, eval_length):
            device_batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()
                            if isinstance(v, np.ndarray)}
            for (entry, _, _, metrics_list), predict in zip(model_info_list, predictors):
                preds, targets = predict(device_batch)
                metrics_list.append(metric_provider.get_metrics(preds, targets,
                                                                all_frame_cnts=True))
        batches.close()

        out_dir = SETTINGS.OUT_PATH / timestamp("test")
        out_dir.mkdir(parents=True, exist_ok=True)
        if not config["no_vis"]:
            print("Saving visualizations for tested models...")
            if getattr(test_data, "ON_THE_FLY", False):
                self.reset_rng(config["seed"])
            model_predict_fns = {
                entry.NAME.replace(" ", "_").replace("/", "-"): predict
                for (entry, _, _, _), predict in zip(model_info_list, predictors)}
            visualize_sequences(test_data, cfg["context_frames"], cfg["pred_frames"],
                                model_predict_fns, out_dir, n_vis=config["n_vis"],
                                vis_mode=config["vis_mode"], vis_compare=config["vis_compare"],
                                vis_context_frame_idx=config["vis_context_frame_idx"],
                                device=self.device)
        results = {}
        if eval_length > 0:
            logger = _TestLogger(out_dir, test_mode, no_wandb=config["no_wandb"])
            for (entry, _, _, metrics_list) in model_info_list:
                # each horizon keeps its own keys: FVD has values from 9 frames on
                mean_metric_dicts = [
                    {mk: float(np.mean([per_batch[f][mk] for per_batch in metrics_list]))
                     for mk in metrics_list[0][f]}
                    for f in range(len(metrics_list[0]))
                ]
                results[entry.NAME] = mean_metric_dicts
                logger.log_model(entry.NAME, entry.model_dir, mean_metric_dicts)
            logger.finish()
            with open(out_dir / "test_metrics.json", "w") as f:
                json.dump(results, f, indent=2)
        return results

    def test(self, brief_test=False, **run_kwargs):
        r"""Tests every loaded model, and a CopyLastFrame baseline, on every
        loaded test set: the measures of ``run_kwargs["metrics"]`` (a list of
        names, or ``"all"``) for each prediction horizon 1..``pred_frames``,
        averaged over the test batches (the first 10 with ``brief_test``).
        Returns one ``{model NAME: [dict per horizon]}`` per test set; models
        of the same NAME share one entry, the last one tested. The results
        are also written to ``test_metrics.jsonl`` and ``test_metrics.json``
        in a new directory under ``SETTINGS.OUT_PATH``, and, unless
        ``no_vis``, each model's videos of ``n_vis`` test items
        (``vis_{i}_{model}.gif``), with ``vis_compare`` a comparison image
        per item (``compare_{i}.png``), and ``vis_info.txt``."""
        test_sets_and_model_lists, run_config = self._prepare_testing(**run_kwargs)
        return [self._test_on_dataset(model_info_list, test_set, run_config, brief_test)
                for test_set, model_info_list in test_sets_and_model_lists]

    # ------------------------------------------------------------------ #
    # inference
    def predict(self, frames, actions=None, pred_frames: int = None, model_idx: int = -1):
        r"""Direct inference: context ``frames`` ``[b, t, h, w, c]`` (or one
        ``[t, h, w, c]`` sequence) in the model's value range ->
        ``[b, pred_frames, h, w, c]`` float32 predictions of the frames after
        them, on the suite's device. ``actions``, when given, must cover
        ``t + pred_frames`` steps."""
        if not self.models:
            raise ValueError("No model available for prediction")
        entry = self.models[model_idx]
        model = entry.model
        pred_frames = pred_frames or 1
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        squeeze = frames.dim() == 4
        if squeeze:
            frames = frames[None]
        b, ctx = frames.shape[:2]
        if ctx < (model.MIN_CONTEXT_FRAMES or 1):
            raise ValueError(f"need at least {model.MIN_CONTEXT_FRAMES} "
                             f"context frames, got {ctx}")
        total = ctx + pred_frames
        if model.NEEDS_COMPLETE_INPUT:
            frames = torch.cat([frames, frames.new_zeros((b, pred_frames, *frames.shape[2:]))],
                               dim=1)
        if actions is not None:
            actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
            if squeeze and actions.dim() == 2:
                actions = actions[None]
            if actions.shape[1] < total:
                raise ValueError(f"actions must cover context + horizon "
                                 f"({total} steps), got {actions.shape[1]}")
            actions = actions[:, :total]
        else:
            actions = torch.zeros((b, total, max(model.action_size, 1)), dtype=torch.float32,
                                  device=self.device)

        key = (ctx, pred_frames, bool(model.action_conditional))
        if key not in entry.predict_fns:
            entry.predict_fns[key] = make_predict_fn(
                model, {"context_frames": ctx, "pred_frames": pred_frames,
                        "use_actions": model.action_conditional})
        preds, _ = entry.predict_fns[key]({"frames": frames, "actions": actions})
        return preds[0] if squeeze else preds

    def export_model(self, out_path, context_frames: int, pred_frames: int,
                     batch_size: int = 1, model_idx: int = -1, compute_dtype=None):
        r"""Exports a model's inference path with ``torch.export`` to one
        ``.pt2`` file (:mod:`vp_suite_tpu_torch.serving`) and returns its
        path; ``serving.load_predictor`` loads it with torch and the port's
        operators. ``batch_size=None`` gives a batch-polymorphic program,
        ``compute_dtype=torch.bfloat16`` a bf16 serving graph (f32 in and
        out)."""
        from vp_suite_tpu_torch.serving import export_predictor, save_predictor
        if not self.models:
            raise ValueError("No model available to export")
        entry = self.models[model_idx]
        exported = export_predictor(entry.model, entry.state, context_frames, pred_frames,
                                    batch_size=batch_size, compute_dtype=compute_dtype)
        return save_predictor(exported, out_path)


def _check_devices(run_config, split):
    r"""Refuses, before any work, a device count that the run cannot have:
    a ``batch_size`` that ``num_devices`` does not divide (training), and
    ``num_devices`` > 1 in one process without a group (one process runs one
    device), and an unknown ``ckpt_backend``."""
    n = run_config["num_devices"]
    if split == "train" and n and run_config["batch_size"] % n != 0:
        raise ValueError(f"batch_size {run_config['batch_size']} not divisible by {n} devices")
    if n > 1 and not (run_config["multihost"] or is_grouped()):
        make_mesh(n)
    if run_config["ckpt_backend"] not in ("msgpack", "orbax"):
        raise ValueError(f"ckpt_backend must be 'msgpack' or 'orbax', "
                         f"not '{run_config['ckpt_backend']}'")


def _silent(*args, **kwargs):
    r"""``print`` of the processes other than rank 0."""


def _apply_suggestions(trial, optuna_config, run_config, model_name):
    r"""Replaces run options by a hyperopt trial's suggestions, as the JAX
    package's ``train`` does: ``choices`` by ``suggest_categorical``
    (``model_type`` is skipped with a warning), ``type: int`` by
    ``suggest_int``, others by ``suggest_float``, in log space where
    ``scale`` is ``"log"``."""
    for param, p_dict in optuna_config.items():
        if "choices" in p_dict:
            if param == "model_type":
                warnings.warn("hyperopt across model and dataset parameters is not yet "
                              f"supported -> using {model_name}")
                continue
            run_config[param] = trial.suggest_categorical(param, p_dict["choices"])
        elif p_dict.get("type") == "int":
            run_config[param] = trial.suggest_int(param, p_dict["min"], p_dict["max"])
        else:
            run_config[param] = trial.suggest_float(
                param, p_dict["min"], p_dict["max"], log=p_dict.get("scale", "uniform") == "log")


def _start_profiler(device):
    r"""A started ``torch.profiler`` recording the host, and the card when
    ``device`` is one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir, epoch):
    r"""Stops ``profiler`` and writes its Chrome trace
    ``profile_dir/trace_epoch_{NNN}.json``."""
    profiler.stop()
    Path(profile_dir).mkdir(parents=True, exist_ok=True)
    path = Path(profile_dir) / f"trace_epoch_{epoch + 1:03d}.json"
    profiler.export_chrome_trace(str(path))
    print(f"  profile of epoch {epoch + 1} written to {path}")


class _RunLogger:
    r"""Metric sink: ``metrics.jsonl`` (and the console) always, wandb when
    it is importable and not turned off."""

    def __init__(self, out_path, config, no_wandb, project):
        self.jsonl_fp = Path(out_path) / "metrics.jsonl"
        self.wandb = None
        if not no_wandb:
            try:
                import wandb
                wandb.init(config={k: str(v) for k, v in config.items()},
                           project=project, dir=str(SETTINGS.RUN_PATH))
                self.wandb = wandb
            except Exception as e:   # logging is optional: train on without it
                print(f"wandb logging is off ({type(e).__name__}: {e})")

    def log_epoch(self, epoch, val_losses):
        rec = {"epoch": epoch, **{k: float(v) for k, v in val_losses.items()}}
        with open(self.jsonl_fp, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(val_losses)

    def finish(self):
        if self.wandb is not None:
            self.wandb.finish()


class _NullLogger:
    r"""The metric sink of the processes other than rank 0: nothing."""

    def log_epoch(self, epoch, val_losses):
        pass

    def finish(self):
        pass


class _TestLogger:
    r"""Test-run metric sink: ``test_metrics.jsonl`` (one record per model
    and horizon) and the console always; with wandb importable and not
    turned off, one wandb run per tested model in the project
    'vp-suite-testing'."""

    PROJECT = "vp-suite-testing"

    def __init__(self, out_dir, test_mode, no_wandb=False):
        self.jsonl_fp = Path(out_dir) / "test_metrics.jsonl"
        self.test_mode = test_mode
        self.wandb = None
        self._n_logged = 0
        if not no_wandb:
            try:
                import wandb
                self.wandb = wandb
            except ImportError as e:   # logging is optional: test on without it
                print(f"wandb logging is off ({e})")

    def log_model(self, model_name, model_dir, mean_metric_dicts):
        with open(self.jsonl_fp, "a") as f:
            for fi, mmd in enumerate(mean_metric_dicts):
                f.write(json.dumps({"model": model_name, "model_dir": str(model_dir),
                                    "test_mode": self.test_mode,
                                    "pred_frames": fi + 1, **mmd}) + "\n")
        print(f"\n{model_name} (path: {model_dir}): ")
        for fi, mmd in enumerate(mean_metric_dicts):
            print(f"pred_frames: {fi + 1}")
            for k, v in mmd.items():
                print(f" -> {k}: {v}")
        if self.wandb is not None:
            try:
                self.wandb.init(
                    config={"test_mode": self.test_mode, "model_dir": str(model_dir)},
                    project=self.PROJECT, name=f"{model_name} ({self.test_mode} test)",
                    dir=str(SETTINGS.RUN_PATH), reinit=(self._n_logged > 0))
                for fi, mmd in enumerate(mean_metric_dicts):
                    self.wandb.log({"pred_frames": fi + 1, **mmd})
            except Exception as e:   # logging is optional: the JSONL record stands
                print(f"wandb test logging failed ({type(e).__name__}: {e}); "
                      f"continuing with JSONL only")
                self.wandb = None
        self._n_logged += 1

    def finish(self):
        if self.wandb is not None:
            self.wandb.finish()
