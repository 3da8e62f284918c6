r"""Hyperparameter search samplers without optuna: the port's own copy of
the JAX package's ``training/hyperopt.py`` (pure numpy, the same behaviour:
the same suggestions from the same seed and the same trial values).

``VPSuite.hyperopt`` uses optuna's TPE sampler where optuna is installed,
as the reference does, and :class:`TPEStudy` otherwise, with the same
``Study.optimize`` / ``best_params`` surface; :class:`RandomSearchStudy` is
the plain random-search baseline.

TPE-lite (univariate Tree-structured Parzen Estimator, Bergstra et al. 2011):
after ``n_startup`` random trials, each new suggestion for a parameter

1. splits completed trials into the best ``gamma`` fraction ("good") and the
   rest ("bad"),
2. fits Parzen windows l(x) over good values and g(x) over bad values
   (Gaussian kernels for float/int, in log space for log-scale params;
   smoothed count histograms for categoricals),
3. draws candidates from l and keeps the one maximising l(x)/g(x).
"""
import math

import numpy as np


class Trial:
    r"""Minimal optuna-Trial-compatible object; forwards suggestions to the
    owning study's sampler."""

    def __init__(self, number, study):
        self.number = number
        self._study = study
        self.params = {}

    def suggest_categorical(self, name, choices):
        val = self._study._suggest(name, {"kind": "cat", "choices": list(choices)})
        self.params[name] = val
        return val

    def suggest_int(self, name, low, high, step=1):
        val = int(round(self._study._suggest(
            name, {"kind": "int", "low": low, "high": high})))
        val = int(np.clip(val, low, high))
        self.params[name] = val
        return val

    def suggest_float(self, name, low, high, log=False, step=None):
        val = float(self._study._suggest(
            name, {"kind": "float", "low": low, "high": high, "log": log}))
        self.params[name] = val
        return val


class RandomSearchStudy:
    r"""Pure random search; optuna-Study-compatible surface."""

    def __init__(self, direction="minimize", seed=0):
        self.direction = direction
        self.rng = np.random.default_rng(seed)
        self.trials = []

    # -- sampling ------------------------------------------------------- #
    def _suggest(self, name, spec):
        return self._random(spec)

    def _random(self, spec):
        if spec["kind"] == "cat":
            return spec["choices"][int(self.rng.integers(len(spec["choices"])))]
        lo, hi = spec["low"], spec["high"]
        if spec["kind"] == "int":
            return int(self.rng.integers(lo, hi + 1))
        if spec.get("log"):
            return float(np.exp(self.rng.uniform(np.log(lo), np.log(hi))))
        return float(self.rng.uniform(lo, hi))

    # -- driver --------------------------------------------------------- #
    def optimize(self, func, n_trials=10):
        for i in range(len(self.trials), len(self.trials) + n_trials):
            trial = Trial(i, self)
            value = func(trial)
            self.trials.append((float(value), trial.params))

    @property
    def best_params(self):
        if not self.trials:
            return {}
        key = (lambda t: -t[0]) if self.direction == "maximize" else (lambda t: t[0])
        return min(self.trials, key=key)[1]


class TPEStudy(RandomSearchStudy):
    r"""TPE-lite study: random for the first ``n_startup`` trials, then
    Parzen-estimator guided sampling (candidates from the good-trial density,
    ranked by the good/bad likelihood ratio)."""

    def __init__(self, direction="minimize", seed=0, n_startup=5, gamma=0.25,
                 n_candidates=24):
        super().__init__(direction, seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates

    def _split(self, name):
        r"""Completed values of ``name`` split into (good, bad) by objective."""
        obs = [(v, p[name]) for v, p in self.trials if name in p]
        if not obs:
            return [], []
        sign = -1.0 if self.direction == "maximize" else 1.0
        obs.sort(key=lambda t: sign * t[0])
        n_good = max(1, int(math.ceil(self.gamma * len(obs))))
        return [x for _, x in obs[:n_good]], [x for _, x in obs[n_good:]]

    def _suggest(self, name, spec):
        if len(self.trials) < self.n_startup:
            return self._random(spec)
        good, bad = self._split(name)
        if not good or not bad:
            return self._random(spec)
        if spec["kind"] == "cat":
            return self._suggest_cat(spec, good, bad)
        return self._suggest_numeric(spec, good, bad)

    def _suggest_cat(self, spec, good, bad):
        choices = spec["choices"]

        def probs(vals):
            counts = np.array([1.0 + sum(v == c for v in vals) for c in choices])
            return counts / counts.sum()

        pg, pb = probs(good), probs(bad)
        cand = self.rng.choice(len(choices), size=self.n_candidates, p=pg)
        best = max(cand, key=lambda i: pg[i] / pb[i])
        return choices[int(best)]

    def _suggest_numeric(self, spec, good, bad):
        lo, hi = float(spec["low"]), float(spec["high"])
        log = spec.get("log", False) and spec["kind"] == "float"
        to_s = (lambda x: math.log(x)) if log else (lambda x: float(x))
        from_s = (lambda x: math.exp(x)) if log else (lambda x: x)
        s_lo, s_hi = to_s(lo), to_s(hi)
        g = np.array([to_s(x) for x in good])
        b = np.array([to_s(x) for x in bad])
        span = s_hi - s_lo

        def bandwidth(v):
            return max(span / max(math.sqrt(len(v)), 1.0), 1e-3 * span, 1e-12)

        bw_g, bw_b = bandwidth(g), bandwidth(b)

        def density(x, centers, bw):
            z = (x[:, None] - centers[None, :]) / bw
            return np.exp(-0.5 * z * z).sum(axis=1) / (len(centers) * bw) + 1e-12

        # candidates from l(x): a kernel center plus noise, clipped to range
        centers = g[self.rng.integers(len(g), size=self.n_candidates)]
        cand = np.clip(centers + self.rng.normal(0.0, bw_g, self.n_candidates),
                       s_lo, s_hi)
        ratio = density(cand, g, bw_g) / density(cand, b, bw_b)
        return from_s(float(cand[int(np.argmax(ratio))]))
