r"""The port's hyperopt samplers (``training/hyperopt.py``, its own numpy copy
of the JAX package's) and the facade's ``hyperopt`` / ``train(trial=...)``
against the JAX package's.

- The JAX sampler's four cases (``tests/test_hyperopt.py``) on the port's
  copy.
- The same suggestions from the same seed as the JAX ``TPEStudy``, through
  its random start-up and its TPE phase, on pure numpy objectives.
- ``VPSuite.hyperopt`` of 3 trials (within the start-up, where the
  suggestions do not depend on the losses) on EF-ConvLSTM with the JAX
  parameters carried over: the same suggestions, the trial values (the
  first to 1e-5, the later ones, which go on training the same state, to
  1e-3 relative) and the same best parameters as the JAX suite's; the search
  space checked as the JAX package checks it; ``model_type`` skipped.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import vp_suite_tpu.training.hyperopt as jax_hyperopt
import vp_suite_tpu.vpsuite as jax_vpsuite
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu.utils.utils import check_optuna_config as jax_check_optuna_config
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.training.hyperopt import RandomSearchStudy, TPEStudy, Trial
from vp_suite_tpu_torch.utils.jax_params import load_jax_params
from vp_suite_tpu_torch.utils.utils import check_optuna_config

torch.set_num_threads(1)


def _quadratic(trial):
    x = trial.suggest_float("x", -5.0, 5.0)
    y = trial.suggest_float("y", 1e-4, 1e2, log=True)
    return (x - 1.7) ** 2 + (np.log10(y) - 0.5) ** 2


def _best_value(study):
    sign = -1.0 if study.direction == "maximize" else 1.0
    return min(sign * v for v, _ in study.trials)


def test_tpe_beats_random_search_on_quadratic():
    tpe_scores, rnd_scores = [], []
    for seed in range(10):
        tpe = TPEStudy(direction="minimize", seed=seed)
        tpe.optimize(_quadratic, n_trials=40)
        rnd = RandomSearchStudy(direction="minimize", seed=seed)
        rnd.optimize(_quadratic, n_trials=40)
        tpe_scores.append(_best_value(tpe))
        rnd_scores.append(_best_value(rnd))
    assert np.mean(tpe_scores) < np.mean(rnd_scores), (tpe_scores, rnd_scores)


def test_tpe_maximize_direction():
    study = TPEStudy(direction="maximize", seed=0)
    study.optimize(lambda t: -(t.suggest_float("x", -3, 3) - 1.0) ** 2, n_trials=30)
    assert abs(study.best_params["x"] - 1.0) < 0.5


def _int_and_categorical(trial):
    n = trial.suggest_int("n", 1, 20)
    c = trial.suggest_categorical("c", ["a", "b", "c"])
    return abs(n - 13) + (0.0 if c == "b" else 5.0)


def test_tpe_int_and_categorical():
    study = TPEStudy(direction="minimize", seed=3)
    study.optimize(_int_and_categorical, n_trials=40)
    assert study.best_params["c"] == "b"
    assert isinstance(study.best_params["n"], int)
    assert abs(study.best_params["n"] - 13) <= 3


def test_suggestions_respect_bounds():
    seen = []

    def objective(trial):
        x = trial.suggest_float("x", 0.5, 2.0, log=True)
        n = trial.suggest_int("n", -3, 4)
        seen.append((x, n))
        return x

    study = TPEStudy(direction="minimize", seed=1)
    study.optimize(objective, n_trials=25)
    xs, ns = zip(*seen)
    assert min(xs) >= 0.5 and max(xs) <= 2.0
    assert min(ns) >= -3 and max(ns) <= 4


@pytest.mark.parametrize("objective", [_quadratic, _int_and_categorical],
                         ids=["quadratic", "int_and_categorical"])
@pytest.mark.parametrize("kind", ["TPEStudy", "RandomSearchStudy"])
def test_same_suggestions_as_jax(kind, objective):
    r"""30 trials (25 past TPE's random start-up) give the same parameters,
    in order, and the same best parameters in both packages."""
    for seed, direction in ((0, "minimize"), (5, "maximize")):
        port = globals()[kind](direction=direction, seed=seed)
        ref = getattr(jax_hyperopt, kind)(direction=direction, seed=seed)
        port.optimize(objective, n_trials=30)
        ref.optimize(objective, n_trials=30)
        assert port.trials == ref.trials and port.best_params == ref.best_params


def test_trial_records_its_suggestions():
    study = TPEStudy(seed=2)
    trial = Trial(0, study)
    assert trial.suggest_int("n", 3, 3) == 3 and trial.params == {"n": 3}
    assert RandomSearchStudy().best_params == {}


@pytest.mark.parametrize("space", [
    {"lr": {"min": 1e-4, "max": 1e-2, "scale": "log"}, "batch_size": {"choices": [2, 4]}},
    {"lr": {"min": 1.0, "max": 0.1}}, {"lr": {"max": 0.1}}, {"lr": {"choices": []}},
    {"lr": 0.1}, ["lr"]])
def test_search_space_is_checked_as_in_jax(space):
    try:
        jax_check_optuna_config(space)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0].split("'")[0]):
            check_optuna_config(space)
    else:
        check_optuna_config(space)


MMF = dict(img_size=16, digit_source="synthetic", n_seqs={"train": 4, "val": 2, "test": 2})
SPACE = {"lr": {"min": 1e-4, "max": 1e-2, "scale": "log"},
         "losses_and_scales": {"choices": [{"mse": 1.0}, {"mse": 1.0, "l1": 1.0}]},
         "model_type": {"choices": ["convlstm-shi", "trajgru"]}}
RUN = dict(epochs=1, batch_size=2, context_frames=1, pred_frames=1, steps_per_epoch=2,
           no_vis=True, no_wandb=True)


def _recording(study_class, seen):
    class Recording(study_class):
        def optimize(self, func, n_trials=10):
            super().optimize(func, n_trials)
            seen.extend(self.trials)
    return Recording


@pytest.fixture(scope="module")
def hyperopt_runs(tmp_path_factory):
    r"""``hyperopt`` of 3 trials in both packages (one loader worker, the
    port's model on the JAX model's initial parameters); each one's trials
    and best parameters."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vpsuite, "BatchLoader",
                   functools.partial(jax_vpsuite.BatchLoader, num_workers=1))
        seen = []
        mp.setattr(jax_hyperopt, "TPEStudy", _recording(jax_hyperopt.TPEStudy, seen))
        suite = jax_vpsuite.VPSuite(device="cpu", compilation_cache=False)
        suite.load_dataset("MMF", **MMF)
        entry = suite.create_model("convlstm-shi")
        params = jax.tree_util.tree_map(np.asarray, entry.state.params)
        with jax.default_matmul_precision("highest"), \
                pytest.warns(UserWarning, match="hyperopt across model"):
            best = suite.hyperopt(SPACE, n_trials=3, out_dir=str(tmp_path_factory.mktemp("jax")),
                                  **RUN)
        out["jax"] = (seen, best)
    import vp_suite_tpu_torch.training.hyperopt as port_hyperopt
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_vpsuite, "BatchLoader",
                   functools.partial(port_vpsuite.BatchLoader, num_workers=1))
        seen = []
        mp.setattr(port_hyperopt, "TPEStudy", _recording(port_hyperopt.TPEStudy, seen))
        mp.setattr(SETTINGS, "_run_path", tmp_path_factory.mktemp("port_run"))
        suite = VPSuite(device="cpu")
        suite.load_dataset("MMF", **MMF)
        load_jax_params(suite.create_model("convlstm-shi").model, params)
        with pytest.warns(UserWarning, match="hyperopt across model"):
            best = suite.hyperopt(SPACE, n_trials=3,
                                  out_dir=str(tmp_path_factory.mktemp("port")), **RUN)
        out["port"] = (seen, best)
    return out


def test_hyperopt_matches_jax(hyperopt_runs):
    (port_trials, port_best), (jax_trials, jax_best) = hyperopt_runs["port"], hyperopt_runs["jax"]
    assert len(port_trials) == len(jax_trials) == 3
    for i, ((got_value, got_params), (want_value, want_params)) in enumerate(
            zip(port_trials, jax_trials)):
        assert got_params == want_params and set(got_params) == {"lr", "losses_and_scales"}
        # the first trial trains from the same initial weights: 1e-5. Each
        # later one goes on training the state the trial before left, with
        # Adam, whose steps of about lr * sign(g) turn float wiggle in a
        # gradient near 0 into 2 * lr: 1e-3 (measured 3e-4 after one trial)
        np.testing.assert_allclose(got_value, want_value, rtol=1e-5 if i == 0 else 1e-3)
    assert port_best == jax_best


def test_train_with_a_trial_takes_its_suggestions(tmp_path):
    r"""``train(trial=...)`` runs with the suggested options: an int and a
    float from the space, recorded by the trial, and the learning rate
    reaches the optimizer."""
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", **MMF)
    entry = suite.create_model("convlstm-shi")
    trial = Trial(0, RandomSearchStudy(seed=4))
    space = {"lr": {"min": 1e-3, "max": 1e-2}, "steps_per_epoch": {"min": 1, "max": 2,
                                                                     "type": "int"}}
    suite.train(trial=trial, optuna=space, out_dir=str(tmp_path),
                **{k: v for k, v in RUN.items() if k != "steps_per_epoch"})
    assert set(trial.params) == {"lr", "steps_per_epoch"}
    assert isinstance(trial.params["steps_per_epoch"], int)
    assert entry.state.step == trial.params["steps_per_epoch"]
    assert entry.state.optimizer.param_groups[0]["lr"] == pytest.approx(trial.params["lr"])
