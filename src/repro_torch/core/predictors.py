"""Length predictors: a copy of ``repro.core.predictors`` (pure NumPy),
the knowable-length assumption as a first-class knob.

Every length-aware discipline in this repo — SRPT's shortest-first
membership, multi-bin's routing, the paper's clipping analysis — assumes
the output token count of a request is knowable before it is served.  The
simulators so far realized that assumption with an *oracle*: the true
sampled length.  Multi-Bin Batching (Guldogan et al. 2024) analyzes
exactly how binning gains erode under prediction error, and AugServe
(2025) argues adaptive scheduling must be driven by *estimated* request
cost; this module makes the predictor an explicit, swappable component so
both effects are measurable.

A :class:`LengthPredictor` maps true lengths (and, on the serving layers,
prompts) to *predicted* lengths::

    predict(key, true_lengths, prompts=None) -> predicted_lengths

``key`` seeds the predictor's OWN rng stream (a salted
``np.random.SeedSequence``), deliberately separate from the workload rng:
the sampled arrivals/tokens of a :class:`repro_torch.core.policies.Workload`
are bit-identical with or without a predictor, so the oracle predictor
reproduces the pre-predictor trajectories exactly and every layer that
derives predictions from the same ``(key, true_lengths)`` pair sees the
same predicted column.

The predicted-vs-true column convention (enforced across all four
layers — oracle, fastsim, scheduler, engine):

  * **membership / ordering** (who is in the batch, in what order, which
    bin) keys off ``predicted``;
  * **clipping and the service law** (``n_max``, ``H[b, max]`` padding,
    elastic completion) keep the TRUE lengths — the machine decodes what
    the request actually needs, not what the predictor guessed.

Registered predictors (``PREDICTORS``):

  * ``oracle``           — predicted == true (the default)
  * ``lognormal_noise``  — multiplicative mean-preserving lognormal error,
    the standard model for relative length-prediction error
  * ``additive_noise``   — Gaussian token-count error, floor at 1
  * ``bucket``           — quantile-bucket classifier with configurable
    accuracy (mimics the class-label predictors served in production:
    a correct bucket yields the bucket's representative length, a miss
    yields a uniformly random bucket's)
  * ``learned``          — a small learned head: ridge regression from
    noisy prompt features to log-length, trained on a sampled workload
    (``fit``).  The features are a synthetic observation model (K noisy
    views of the true log-length standing in for prompt signals); a real
    deployment would substitute an embedding of the prompt.
  * ``prompt_features``  — the real-prompt twin of ``learned``: the same
    ridge head, but over features computed from the actual prompt token
    arrays flowing through ``predict(key, true, prompts)`` (length stats
    + token-id statistics), trained on served (prompt, output-length)
    pairs (``fit_requests``).  The first predictor that never peeks at
    the true lengths.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Type

import numpy as np

# Salt for the predictor rng stream: keeps predictor noise independent of
# the workload stream sampled from the same user-facing seed.
_PRED_SALT = 0x9E3779B9

PREDICTORS: Dict[str, Type["LengthPredictor"]] = {}


def register_predictor(cls: Type["LengthPredictor"]) -> Type["LengthPredictor"]:
    PREDICTORS[cls.name] = cls
    return cls


def get_predictor(name: str, **kwargs) -> "LengthPredictor":
    return PREDICTORS[name](**kwargs)


def _key_rng(key) -> np.random.Generator:
    """Deterministic per-key rng, salted away from the workload stream.

    ``key`` is whatever the caller uses to identify the draw — the
    workload seed on the simulator layers, any int on the serving layers."""
    if isinstance(key, (tuple, list)):
        parts = [int(k) for k in key]
    else:
        parts = [int(key)]
    return np.random.default_rng(np.random.SeedSequence([_PRED_SALT] + parts))


class LengthPredictor:
    """Base predictor: ``predict`` returns one float64 predicted length per
    request.  Predictions must be positive (formation code may bin or sort
    them) but are otherwise unconstrained — they deliberately do NOT clip
    to ``n_max``; clipping belongs to the true-length column."""

    name = "base"

    def predict(self, key, true_lengths: np.ndarray,
                prompts: Optional[Sequence] = None) -> np.ndarray:
        raise NotImplementedError

    def __repr__(self):
        keys = {k: v for k, v in vars(self).items()
                if not k.startswith("_") and not isinstance(v, np.ndarray)}
        return f"{type(self).__name__}({keys})"


@register_predictor
class OraclePredictor(LengthPredictor):
    """Predicted == true.  The pre-predictor behavior of SRPT and
    multi-bin: trajectories are bit-equal to a policy with no predictor."""

    name = "oracle"

    def predict(self, key, true_lengths, prompts=None) -> np.ndarray:
        return np.asarray(true_lengths, np.float64)


@register_predictor
class LogNormalNoisePredictor(LengthPredictor):
    """Multiplicative mean-preserving lognormal error:

        pred = true * exp(sigma * Z - sigma^2 / 2),   Z ~ N(0, 1)

    ``E[pred | true] = true`` for every request, so sigma moves ONLY the
    relative prediction error (log-RMSE == sigma), not the predicted
    load.  sigma=0 reproduces the oracle exactly.  ``bias`` shifts the
    log-prediction (systematic over/under-estimation)."""

    name = "lognormal_noise"

    def __init__(self, sigma: float = 0.3, bias: float = 0.0):
        self.sigma = float(sigma)
        self.bias = float(bias)

    def predict(self, key, true_lengths, prompts=None) -> np.ndarray:
        true = np.asarray(true_lengths, np.float64)
        z = _key_rng(key).standard_normal(len(true))
        factor = np.exp(self.sigma * z - 0.5 * self.sigma ** 2 + self.bias)
        return np.maximum(true * factor, 1.0)


@register_predictor
class AdditiveNoisePredictor(LengthPredictor):
    """Additive Gaussian token-count error: pred = max(true + std*Z, 1).
    Unlike the multiplicative model, short requests are hit hardest in
    relative terms — the regime where SRPT's ordering is most fragile."""

    name = "additive_noise"

    def __init__(self, std: float = 50.0):
        self.std = float(std)

    def predict(self, key, true_lengths, prompts=None) -> np.ndarray:
        true = np.asarray(true_lengths, np.float64)
        z = _key_rng(key).standard_normal(len(true))
        return np.maximum(true + self.std * z, 1.0)


@register_predictor
class BucketPredictor(LengthPredictor):
    """Quantile-bucket classifier with configurable accuracy.

    The request's true bucket (``num_buckets`` equal-mass buckets over the
    batch's empirical quantiles, or explicit ``edges``) is predicted with
    probability ``accuracy``; a miss predicts a uniformly random bucket.
    The predicted length is the bucket's representative (its median
    quantile), so even a perfect classifier (``accuracy=1``) quantizes —
    the granularity/accuracy trade-off of production length classifiers."""

    name = "bucket"

    def __init__(self, num_buckets: int = 8, accuracy: float = 0.9,
                 edges: Optional[Sequence[float]] = None):
        assert 0.0 <= accuracy <= 1.0
        self.num_buckets = int(num_buckets if edges is None
                               else len(edges) + 1)
        self.accuracy = float(accuracy)
        self.edges = None if edges is None else tuple(float(e) for e in edges)

    def predict(self, key, true_lengths, prompts=None) -> np.ndarray:
        true = np.asarray(true_lengths, np.float64)
        B = self.num_buckets
        if self.edges is not None:
            edges = np.asarray(self.edges, np.float64)
        else:
            edges = np.quantile(true, np.arange(1, B) / B)
        # representative length per bucket: the bucket's median member
        reps = np.empty(B)
        bins_true = np.searchsorted(edges, true, side="left")
        for j in range(B):
            members = true[bins_true == j]
            if members.size:
                reps[j] = float(np.median(members))
            else:  # empty bucket: fall back to its lower edge
                reps[j] = float(edges[j - 1]) if j > 0 else 1.0
        rng = _key_rng(key)
        correct = rng.random(len(true)) < self.accuracy
        random_bin = rng.integers(0, B, len(true))
        bins = np.where(correct, bins_true, random_bin)
        return np.maximum(reps[bins], 1.0)


@register_predictor
class LearnedPredictor(LengthPredictor):
    """A small learned head: ridge regression from prompt features to
    log-length, trained on a sampled workload.

    The feature channel is a synthetic observation model standing in for
    prompt signals: ``n_features`` noisy views of the true log-length,
    each ``w_k * log(true) + feature_noise * Z`` with fixed weights
    ``w_k``, plus one pure-noise distractor.  The head never sees the
    true length at predict time — only the features — so its error floor
    is set by ``feature_noise``; combining K informative views and
    shrinking toward the training mean is what lets it beat a single
    noisy observation (``lognormal_noise`` at sigma=feature_noise) at
    matched per-feature error.  On the serving layers a real deployment
    would replace ``_features`` with an embedding of ``prompts``.

    Call :meth:`fit` (or construct via :meth:`fitted`) before predicting.
    """

    name = "learned"

    _WEIGHTS = (1.0, 0.6, 0.3)      # informative views of log(true)

    def __init__(self, feature_noise: float = 0.5, ridge: float = 1e-3):
        self.feature_noise = float(feature_noise)
        self.ridge = float(ridge)
        self._coef: Optional[np.ndarray] = None

    # ---------------- observation model ----------------
    def _features(self, true: np.ndarray, rng: np.random.Generator):
        logn = np.log(np.maximum(true, 1.0))
        cols = [np.ones_like(logn)]
        for w in self._WEIGHTS:
            cols.append(w * logn
                        + self.feature_noise * rng.standard_normal(len(logn)))
        cols.append(rng.standard_normal(len(logn)))       # distractor
        return np.stack(cols, axis=1)

    # ---------------- training ----------------
    def fit(self, dist, num_train: int = 20_000,
            seed: int = 0) -> "LearnedPredictor":
        """Train on a workload sampled from ``dist`` (a
        ``TokenDistribution``): features -> log(true), ridge-regularized."""
        rng = _key_rng((seed, 1))
        true = dist.sample(rng, num_train).astype(np.float64)
        true = np.maximum(true, 1.0)
        X = self._features(true, rng)
        y = np.log(true)
        A = X.T @ X + self.ridge * np.eye(X.shape[1])
        self._coef = np.linalg.solve(A, X.T @ y)
        return self

    @classmethod
    def fitted(cls, dist, num_train: int = 20_000, seed: int = 0,
               **kwargs) -> "LearnedPredictor":
        return cls(**kwargs).fit(dist, num_train=num_train, seed=seed)

    # ---------------- inference ----------------
    def predict(self, key, true_lengths, prompts=None) -> np.ndarray:
        assert self._coef is not None, \
            "LearnedPredictor.predict before fit(); use LearnedPredictor.fitted"
        true = np.asarray(true_lengths, np.float64)
        X = self._features(np.maximum(true, 1.0), _key_rng(key))
        return np.maximum(np.exp(X @ self._coef), 1.0)


@register_predictor
class PromptFeaturePredictor(LengthPredictor):
    """A length predictor driven by REAL prompt-derived features — the
    first predictor whose ``prompts`` argument (already plumbed through
    ``predict(key, true, prompts)`` on every serving layer) is load-
    bearing.  Ridge regression from per-prompt features to log-length,
    reusing the :class:`LearnedPredictor` recipe but with an observation
    model the serving layers actually possess: the prompt token array.

    Features per prompt: [1, log1p(len), sqrt(len), mean token id (scaled)]
    — length carries the signal when the workload's prompt lengths
    correlate with output requirements
    (:func:`repro_torch.data.pipeline.make_request_stream` with
    ``prompt_len_corr > 0``; real traces have exactly this shape), the id
    statistic is a cheap content stand-in.  Train on (prompt, observed
    output length) pairs with :meth:`fit_requests` — in production these
    are the completions the serving engine has already returned.

    ``predict`` never reads ``true_lengths`` (only their count): unlike
    the synthetic noise models, its information comes solely from the
    prompts.  Without prompts (the prompt-less simulator layers) or
    before fitting it falls back to the training marginal — a constant
    prediction, the honest no-information answer."""

    name = "prompt_features"

    def __init__(self, ridge: float = 1e-3):
        self.ridge = float(ridge)
        self._coef: Optional[np.ndarray] = None
        self._y_mean: float = np.log(256.0)     # unfitted fallback marginal

    # ---------------- observation model ----------------
    @staticmethod
    def _features(prompts) -> np.ndarray:
        lens = np.asarray([len(p) for p in prompts], np.float64)
        means = np.asarray([float(np.mean(p)) if len(p) else 0.0
                            for p in prompts], np.float64)
        return np.stack([np.ones_like(lens), np.log1p(lens), np.sqrt(lens),
                         means / 1000.0], axis=1)

    # ---------------- training ----------------
    def fit_requests(self, reqs) -> "PromptFeaturePredictor":
        """Train on served requests (``repro_torch.data.pipeline.Request``):
        prompt features -> log observed output length."""
        X = self._features([r.prompt_tokens for r in reqs])
        y = np.log(np.maximum([r.target_output_tokens for r in reqs], 1.0))
        A = X.T @ X + self.ridge * np.eye(X.shape[1])
        self._coef = np.linalg.solve(A, X.T @ y)
        self._y_mean = float(np.mean(y))
        return self

    @classmethod
    def fitted_on(cls, reqs, **kwargs) -> "PromptFeaturePredictor":
        return cls(**kwargs).fit_requests(reqs)

    # ---------------- inference ----------------
    def predict(self, key, true_lengths, prompts=None) -> np.ndarray:
        n = len(true_lengths)
        if prompts is None or self._coef is None or len(prompts) < n:
            # no prompt signal: the training marginal (constant) — keeps
            # the prompt-less simulator layers running with honest
            # no-information predictions
            return np.full(n, max(float(np.exp(self._y_mean)), 1.0))
        return np.maximum(np.exp(self._features(prompts[:n]) @ self._coef),
                          1.0)


def prediction_log_rmse(pred: np.ndarray, true: np.ndarray) -> float:
    """Root-mean-square log error — the scale on which ``lognormal_noise``'s
    sigma lives, so predictor families are comparable at matched error."""
    pred = np.maximum(np.asarray(pred, np.float64), 1.0)
    true = np.maximum(np.asarray(true, np.float64), 1.0)
    return float(np.sqrt(np.mean((np.log(pred) - np.log(true)) ** 2)))


def predictor_from_spec(spec) -> LengthPredictor:
    """``LengthPredictor`` | name | ``{"kind": name, **params}`` -> instance."""
    if isinstance(spec, LengthPredictor):
        return spec
    if isinstance(spec, str):
        return get_predictor(spec)
    spec = dict(spec)
    return get_predictor(spec.pop("kind"), **spec)


def resolve_predictions(policy, predictor, key, true_lengths: np.ndarray,
                        prompts: Optional[Sequence] = None):
    """The predicted-length column for a request batch, resolved ONCE for
    every serving-layer consumer (``PolicyScheduler``,
    ``run_engine_schedule``, ``FleetScheduler``, ``run_fleet_schedule``):
    an explicit ``predictor`` (instance / registry name / spec dict)
    overrides the policy's own; None with no policy predictor means oracle
    semantics (formation falls back to the true lengths).  One definition
    so the layers cannot diverge on the convention."""
    if predictor is not None:
        return predictor_from_spec(predictor).predict(key, true_lengths,
                                                      prompts)
    return policy.predict_lengths(key, true_lengths, prompts)


__all__ = [
    "AdditiveNoisePredictor", "BucketPredictor", "LearnedPredictor",
    "LengthPredictor", "LogNormalNoisePredictor", "OraclePredictor",
    "PromptFeaturePredictor",
    "PREDICTORS", "get_predictor", "prediction_log_rmse",
    "predictor_from_spec", "register_predictor", "resolve_predictions",
]
