"""ABCSMC on the fused single-device path
(``pyabc_tpu/inference/smc.py::ABCSMC`` counterpart).

``ABCSMC(model, prior, distance, ...).new(db, observed)`` then ``.run()``;
``ABCSMC([m0, m1, ...], [p0, p1, ...], ...)`` selects between models (the
fused single-device path with one MultivariateNormalTransition per model,
a model prior and a ModelPerturbationKernel; not with a stochastic
acceptor, as in the JAX package).
Generations are grouped into chunks of ``fused_generations``: within a
chunk the host reads only the per-round counters; the accepted rows of the
chunk come back in one packed fetch (K10), after which the chunk's
generations are persisted to History. The device carries epsilon, distance
weights and transition parameters between generations and chunks.

Noisy ABC (a noise kernel, ``IndependentNormalKernel``, ``NormalKernel``,
``IndependentLaplaceKernel``, ``BinomialKernel``, ``PoissonKernel`` or
``NegativeBinomialKernel``, + ``StochasticAcceptor`` + ``Temperature`` or
``ListTemperature``) runs on the same loop: the device
carries the temperature (in epsilon's place; History's ``epsilon`` column
holds it, as in the JAX package), the pdf norm, the largest kernel value
found and Daly's k, and the host objects (``acceptor.pdf_norms``,
``eps.temperatures``) mirror them after each chunk's fetch.

Segmented early reject (``early_reject="auto"`` or ``True`` with a
segmented model, ``TorchModel(segmented=...)``: the tau-leap models of
``models.gillespie`` with ``segments=``, the network SIR, the ODE family
of ``models.model_selection.ode_family(segments=...)``): each round's
simulator call becomes K18, which retires candidates between segments once
the p-norm's prefix bound proves them rejected. Under a fixed p-norm the
accepted populations are bit-identical with early reject on and off, one
model or several (K > 1: each slot steps its own model). Under a
``StochasticAcceptor`` (one model) a candidate retires once the noise
kernel's log-density upper bound proves its pre-committed accept draw
cannot pass: populations, weights and the temperature trail are
bit-identical on and off. Under an
adaptive p-norm whose scale has a moment form the refit runs over every
resolved candidate's simulated columns (K22), as the JAX engine's, so on
and off agree in law, not in bits. A configuration the JAX package's
engine cannot serve takes the classic path (``"auto"``) or raises its
``ValueError`` (``True``), and ``"auto"`` records the fallback with its
reason in ``capability_fallbacks`` and the first generation's telemetry;
one the JAX engine serves but the port does not yet (a user's segmented
model on the card, sharded runs) raises ``not_ported``. History's
telemetry column holds each generation's ``retired_early``,
``segment_occupancy``, ``seg_steps`` and ``seg_resolved``.

LocalTransition (``transitions=LocalTransition(...)``, one model, a
UniformAcceptor, a p-norm distance, a quantile, list or constant epsilon,
a constant population): the device fits it in the generation step (K15,
K12, K13) and proposes from it (K2's local mode, K14). ``refit_every`` and
``refit_drift_threshold`` set the JAX package's refit cadence (auto: every
16 generations from a population capacity of 16384, else every
generation); under it a refit also runs when the drift of the accepted
population against the fitted one passes the threshold, and
``refit_events`` and History's telemetry hold each generation's
``refit``, ``drift`` and ``refit_rows_changed``.

Aggregated distances (``AggregatedDistance`` and
``AdaptiveAggregatedDistance`` over at most eight plain ``PNormDistance``
sub-distances, the JAX package's fused-path conditions) run through K25,
and early reject through K18's aggregate mode (not under an adaptive
aggregate or negative weights, as in the JAX package). A user's
per-generation weight schedule (``PNormDistance(weights={t: ...})``, an
aggregate's top-level or sub-distance schedule) goes to the card as one
``(G, P)`` table a chunk, copied once and never read back. The measure-list
distances of the JAX package (``ZScoreDistance``, ``PCADistance``, ...)
run on its host loop only and raise ``not_ported``.

Learned summary statistics (``PNormDistance(p, sumstat=PredictorSumstat(
LinearPredictor(...)))``, the same with ``MLPPredictor(...)``, or either
under ``AdaptivePNormDistance``; one model, a uniform acceptor; the JAX
package's device-fit plans ``linear`` and ``mlp``):
generation 0 runs on the raw statistics as a chunk of its own (the
predictor is unfitted, the transform the identity; its rows fetched in
float32), then the host fits the predictor on it in float64
(``PredictorSumstat.update``; the MLP standardizes on the host and runs its
Adam steps through K23's MLP fit on the card), and on the device an
adaptive distance refits its weights in the new feature space and
generation 0's distances are recomputed there for the next epsilon. From generation 1 the fitted
transform rides the device carry: every accept runs through it (K23), each
chunk's last generation refits it on the device (K23's fit, no host read)
and the fetch ships the C'-wide transformed rows; the host mirrors each
boundary fit into the predictor after the chunk's fetch. Under early
reject a linear plan with a plain p = 2 norm folds the transformed bound
(K18's LinBound); an MLP transform has no such bound and keeps the
classic kernel, as in the JAX package.

Every other learned statistic of one model runs the JAX package's
host-refit mode (``LassoPredictor``, ``GPPredictor``,
``ModelSelectionPredictor``, ``IdentitySumstat(trafos=...)``,
``fit_every`` other than 1, a generation 0 below the seed fit's rows):
generation 0 is a chunk of its own, every fetch ships raw float32 rows
(History stores them), and at each chunk's boundary the host builds the
chunk's last population and calls ``PredictorSumstat.update(t, pop)`` with
the JAX package's ``t`` (the next chunk's first generation). Where the
transform changed, or under an adaptive distance after generation 0, the
device takes the new parameters, refits an adaptive distance's weights in
their space over the accepted rows (over the record ring after generation
0), recomputes the population's distances and takes the next epsilon on
them (``DeviceContext.boundary_transform``); otherwise the chunk's own
carry goes on. Inside a chunk the transform's parameters stay constant
and the rounds run its kind's kernel (K23's linear or MLP transform, the
GP kernel, K5 after an ``IdentitySumstat``'s functions); early reject
stays off with the JAX package's reason and History's telemetry says
``mode: "host"``. A predictor fitted before the run, more than eight
parameters, a shape beyond the transform kernels and several models
raise ``not_ported``.

Population sizes (``population_size=`` an int, ``ConstantPopulationSize``,
``ListPopulationSize`` or ``AdaptivePopulationSize`` with a finite
``max_population_size``; the MVN transition, one model or several): the
reservoir, the round's lanes and the round cap are sized to the largest n
(the list's, or ``max(start, max_population_size)``), and each generation
keeps its own n. Under the adaptive size K16 picks the next n on the device
after each refit; the host learns it with the next generation's first
counter read (no extra sync), History's telemetry holds each generation's
``n_target`` and ``n_next`` (and, where K16 ran, ``k16_probes``, the
probes that did work, and ``k16_cv_max``, the aggregate CV at max_n), and
``population_strategy.nr_particles`` mirrors the device's decision.
"""
from __future__ import annotations

import datetime
import json
import logging
import math
import time
from typing import Sequence

import numpy as np
import torch

from ..acceptor.acceptor import StochasticAcceptor, UniformAcceptor
from ..core.population import Population
from ..core.random_variables import Distribution
from ..core.sumstat_spec import SumStatSpec
from ..distance.aggregate import (AdaptiveAggregatedDistance,
                                  AggregatedDistance)
from ..distance.kernel import (BinomialKernel, IndependentLaplaceKernel,
                               IndependentNormalKernel,
                               NegativeBinomialKernel, NormalKernel,
                               PoissonKernel, StochasticKernel)
from ..distance.pnorm import AdaptivePNormDistance, PNormDistance
from ..epsilon.base import (ConstantEpsilon, ListEpsilon, MedianEpsilon,
                            QuantileEpsilon)
from ..epsilon.temperature import (ListTemperature, Temperature,
                                   device_config)
from ..kernels.bootstrap_cv import MAX_BOOTSTRAP
from ..kernels.mvn_fit import MAX_MODELS
from ..model import TorchModel
from ..observability.sync import SyncLedger
from ..ops.health import decode
from ..ops.scale_reduce import SHARDED_SCALE_NAMES
from ..ops.segment import occupancy, uniform_protocol_reason
from ..ops.pack import (fetch_dtype_of, pack_models, pack_rows,
                        pack_sumstats, unpack_rows)
from ..kernels.linear_sumstat import MAX_C as MAX_LEARNED
from ..ops.fit import pack_layers, unpack_layers
from ..populationstrategy import (AdaptivePopulationSize,
                                  ConstantPopulationSize, ListPopulationSize)
from ..storage.history import History
from ..sumstat import (PredictorSumstat, device_fit_plan,
                       host_caps_reason, mirror_fitted_params,
                       transform_kind)
from ..sumstat.device import candidates
from ..transition.local_transition import LocalTransition
from ..transition.model_perturbation import ModelPerturbationKernel
from ..transition.multivariatenormal import MultivariateNormalTransition
from ..utils import not_ported as _not_ported
from ..utils import pick_batch, pow2_bucket, resolve_device
from .context import LEARNED_KERNELS, Carry, DeviceContext

logger = logging.getLogger("pyabc_tpu_torch.ABCSMC")

#: the JAX package's DistanceWithMeasureList family: host loop only
MEASURE_LIST_DISTANCES = ("DistanceWithMeasureList", "ZScoreDistance",
                          "PCADistance", "RangeEstimatorDistance",
                          "MinMaxDistance", "PercentileDistance")
#: the noise models the fused noisy path runs (K21a, K21c)
NOISE_KERNELS = (IndependentNormalKernel, NormalKernel,
                 IndependentLaplaceKernel, BinomialKernel, PoissonKernel,
                 NegativeBinomialKernel)


class DegenerateRunError(RuntimeError):
    """A generation's health word came back nonzero."""

    def __init__(self, t: int, word: int):
        self.t, self.word = int(t), int(word)
        super().__init__(
            f"generation {t} failed its health checks: {decode(word)} "
            f"(word {word}); rollback and recovery are not ported yet "
            f"(ROADMAP queue A, item 8)")


def exp_normalize_log_weights(log_w) -> np.ndarray:
    """Stable exp of relative log weights: -inf gives 0, an all-non-finite
    input degrades to uniform weights."""
    log_w = np.asarray(log_w, np.float64)
    finite = np.isfinite(log_w)
    if finite.any():
        return np.where(finite, np.exp(log_w - log_w[finite].max()), 0.0)
    return np.ones_like(log_w)


class ABCSMC:
    #: proposal rounds a generation may take before it counts as failed
    MAX_ROUNDS = 256

    def __init__(self, models, parameter_priors, distance_function=None,
                 population_size=100, summary_statistics=None,
                 model_prior=None, model_perturbation_kernel=None,
                 transitions=None, eps=None, sampler=None, acceptor=None,
                 stop_if_only_single_model_alive: bool = False,
                 max_nr_recorded_particles: float = np.inf,
                 seed: int = 0, mesh=None, sharded=None,
                 early_reject: bool | str = "auto",
                 fused_generations: int = 8,
                 fetch_dtype: str = "float16",
                 checkpoint_path: str | None = None,
                 health_checks: bool = True, ess_floor: float = 0.0,
                 health_acc_floor: float = 0.0,
                 eps_stall_window: int = 16, eps_stall_rtol: float = 1e-6,
                 refit_every: int | None = None,
                 refit_drift_threshold: float = 0.3, device=None):
        models = (list(models) if isinstance(models, Sequence)
                  and not isinstance(models, str) else [models])
        parameter_priors = (list(parameter_priors)
                            if isinstance(parameter_priors, Sequence)
                            else [parameter_priors])
        if len(parameter_priors) != len(models):
            raise ValueError(f"{len(models)} models and "
                             f"{len(parameter_priors)} priors")
        for model in models:
            if not isinstance(model, TorchModel):
                raise _not_ported(
                    f"a {type(model).__name__} model (only TorchModel runs "
                    f"on the device path; host models need the host "
                    f"samplers)", "16")
        if not all(isinstance(p, Distribution) for p in parameter_priors):
            raise TypeError("parameter_priors must be Distributions")
        #: number of models; K > 1 is model selection
        self.K = len(models)
        if self.K > MAX_MODELS:
            raise ValueError(f"{self.K} models: the kernels take at most "
                             f"{MAX_MODELS}")
        if summary_statistics is not None:
            raise _not_ported("a host summary_statistics callable", "16")
        # the model prior (uniform by default) and the perturbation kernel
        # (probability_to_stay 0.7), as in the JAX package
        if model_prior is None:
            self.model_prior_probs = np.full(self.K, 1.0 / self.K)
        else:
            self.model_prior_probs = np.asarray(model_prior, np.float64)
            self.model_prior_probs /= self.model_prior_probs.sum()
        self.model_perturbation_kernel = (
            model_perturbation_kernel
            if model_perturbation_kernel is not None
            else ModelPerturbationKernel(self.K, probability_to_stay=0.7))
        self.stop_if_only_single_model_alive = bool(
            stop_if_only_single_model_alive)
        if sampler is not None:
            raise _not_ported("host samplers", "16")
        if early_reject not in ("auto", True, False):
            raise ValueError(f"early_reject must be 'auto', True or False, "
                             f"got {early_reject!r}")
        #: segmented early reject: "auto" (on whenever capable), True
        #: (required: raise with the blocking reason) or False (never)
        self.early_reject = early_reject
        segmented = any(getattr(m, "segmented", None) is not None
                        for m in models)
        if sharded and segmented and early_reject is not False:
            raise _not_ported("segmented early reject in a sharded run", "13")
        if mesh is not None or sharded:
            raise _not_ported("a device mesh or sharded sampling", "15")
        if checkpoint_path is not None:
            raise _not_ported("mid-chunk checkpoints", "8")
        if np.isfinite(max_nr_recorded_particles):
            raise _not_ported("max_nr_recorded_particles", "12")
        self.models, self.priors = models, parameter_priors
        self.model, self.prior = models[0], parameter_priors[0]
        for model, prior in zip(models, parameter_priors):
            if len(model.space.names) != prior.dim:
                raise ValueError(f"model {model.name} and its prior "
                                 f"disagree in parameter dim")

        distance = (distance_function if distance_function is not None
                    else PNormDistance(p=2))
        if type(distance).__name__ in MEASURE_LIST_DISTANCES:
            # no device twin: the JAX package serves them on its host loop
            raise _not_ported(f"distance {type(distance).__name__} (the "
                              f"JAX package's host loop only)", "16")
        if type(distance) not in (PNormDistance, AdaptivePNormDistance,
                                  AggregatedDistance,
                                  AdaptiveAggregatedDistance,
                                  *NOISE_KERNELS):
            raise _not_ported(f"distance {type(distance).__name__}", "12")
        self._sumstat_gate(distance, parameter_priors)
        self.distance_function = distance
        self.eps = eps if eps is not None else MedianEpsilon()
        acceptor = acceptor if acceptor is not None else UniformAcceptor()
        if type(acceptor) not in (UniformAcceptor, StochasticAcceptor):
            raise _not_ported(f"acceptor {type(acceptor).__name__}", "11")
        self.acceptor = acceptor
        #: noisy ABC: a stochastic acceptor, kernel and temperature
        self.stochastic = type(acceptor) is StochasticAcceptor
        if self.stochastic and self.K > 1:
            raise ValueError("a StochasticAcceptor runs one model only "
                             "(the JAX package's fused noisy ABC is K = 1)")
        if self.stochastic:
            # the JAX package's sanity pairing
            if not isinstance(distance, StochasticKernel):
                raise ValueError("StochasticAcceptor requires a "
                                 "StochasticKernel distance")
            if not isinstance(self.eps, (Temperature, ListTemperature)):
                raise ValueError(
                    "StochasticAcceptor requires a Temperature epsilon (a "
                    "distance-quantile epsilon would yield a negative "
                    "'temperature' and invert acceptance)")
        elif isinstance(distance, StochasticKernel):
            raise _not_ported("a stochastic kernel without a "
                              "StochasticAcceptor", "11")
        elif not isinstance(self.eps, (QuantileEpsilon, ListEpsilon,
                                       ConstantEpsilon)):
            raise _not_ported(f"epsilon {type(self.eps).__name__} without "
                              f"a StochasticAcceptor", "11")
        if isinstance(population_size, (ConstantPopulationSize,
                                        ListPopulationSize,
                                        AdaptivePopulationSize)):
            self.population_strategy = population_size
        elif isinstance(population_size, (int, np.integer)):
            self.population_strategy = ConstantPopulationSize(
                int(population_size))
        else:
            raise _not_ported(f"population strategy "
                              f"{type(population_size).__name__}", "12")
        if (isinstance(population_size, AdaptivePopulationSize)
                and not np.isfinite(population_size.max_population_size)):
            # the JAX package's fused gate: the buffers are sized to the
            # cap, so an unbounded growth target takes its host loop
            raise _not_ported(
                "AdaptivePopulationSize with an unbounded "
                "max_population_size (the fused path sizes its buffers to "
                "the cap; the JAX package serves it on its host loop)", "16")
        if (isinstance(population_size, AdaptivePopulationSize)
                and population_size.n_bootstrap > MAX_BOOTSTRAP):
            # refused before launch, so no generation's work is lost
            raise _not_ported(
                f"AdaptivePopulationSize with n_bootstrap "
                f"{population_size.n_bootstrap} above {MAX_BOOTSTRAP} (K16's "
                f"density holds one log-density a bootstrap in a thread)",
                "12")
        if transitions is None:
            transitions = [MultivariateNormalTransition()
                           for _ in range(self.K)]
        transitions = (list(transitions) if isinstance(transitions, Sequence)
                       else [transitions])
        if len(transitions) != self.K:
            raise ValueError(f"{len(transitions)} transitions for "
                             f"{self.K} models")
        if any(type(tr) is LocalTransition for tr in transitions):
            self._local_gate(acceptor, transitions)
        for tr in transitions:
            if type(tr) not in (LocalTransition,
                                MultivariateNormalTransition):
                raise _not_ported(f"transition {type(tr).__name__}", "12")
        self.transitions = transitions
        self.transition = transitions[0]
        #: LocalTransition's refit cadence: refit every ``refit_every``
        #: generations (None: the JAX package's auto rule) or when the
        #: drift passes ``refit_drift_threshold``
        self.refit_every = (int(refit_every) if refit_every is not None
                            else None)
        self.refit_drift_threshold = float(refit_drift_threshold)
        #: (t, refit, drift, rows_changed) per generation under the cadence
        self.refit_events: list[tuple] = []
        if fetch_dtype not in ("float16", "bfloat16", "float32"):
            raise ValueError(f"fetch_dtype must be float16/bfloat16/"
                             f"float32, got {fetch_dtype!r}")
        self.fetch_dtype = fetch_dtype
        self.fused_generations = max(int(fused_generations), 1)
        self.health_checks = bool(health_checks)
        self.ess_floor = float(ess_floor)
        self.health_acc_floor = float(health_acc_floor)
        self.eps_stall_window = int(eps_stall_window)
        self.eps_stall_rtol = float(eps_stall_rtol)
        self.seed = int(seed)
        self.device = resolve_device(device)
        # the seed keys the kernels' Philox stream (proposals, built-in
        # simulators' noise); a user simulator draws from this generator
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.sync_ledger = SyncLedger()
        #: fast paths the configuration implied and the run could not
        #: take, ``{"gate", "reason"}`` (the JAX package's
        #: ``_capability_fallbacks``)
        self.capability_fallbacks: list[dict] = []
        self.history: History | None = None
        self.x_0: dict | None = None
        self.spec: SumStatSpec | None = None
        #: per-generation host record of the last run: t, eps, rounds,
        #: evaluations, syncs and the host seconds spent proposing and
        #: stepping (compute_s), reading (fetch_s, a chunk's share), handing
        #: the generation to the History's writer (persist_s: the loop's
        #: wait) and the writer thread's own time on it (write_s);
        #: chip_smoke.py reads it
        self.generation_log: list[dict] = []
        #: seconds ``run()`` waited at its end for the writer to drain
        self.flush_s = 0.0
        #: K > 1: the newest persisted generation's model probabilities
        #: (alive models only), as the JAX package's ``_model_probs``
        self.model_probs: dict[int, float] = {}
        #: the host-refit mode of this run's learned statistic (``{"reason":
        #: why no device-fit plan serves it, "seeds": whether generation 0
        #: reaches the first fit}``), None otherwise (``_sumstat_plan``)
        self._sumstat_host: dict | None = None

    def _sumstat_gate(self, distance, priors) -> None:
        """Raise before any launch for a summary statistic the port does
        not serve yet (ROADMAP queue A, item 14): several models, more
        parameters than the learned transforms keep, a statistic or a
        predictor with no transform kernel, user weights or factors."""
        ss = getattr(distance, "sumstat", None)
        if ss is None:
            return
        if self.K > 1:
            raise _not_ported("learned summary statistics with several "
                              "models", "14")
        d_max = max(p.dim for p in priors)
        reason = host_caps_reason(ss, None, d_max)
        if reason is not None:
            raise _not_ported(f"learned summary statistics: {reason}", "14")
        if isinstance(ss, PredictorSumstat) and d_max > MAX_LEARNED:
            raise _not_ported(f"learned summary statistics of {d_max} "
                              f"features (K23's transform keeps at most "
                              f"{MAX_LEARNED})", "14")
        if (distance._weights_arg is not None
                or distance._factors_arg is not None):
            raise _not_ported("user weights or factors with learned "
                              "summary statistics", "14")

    #: the LocalTransition settings the models of one run must share
    LOCAL_SHARED = ("scaling", "k", "k_fraction", "k_max", "selection")

    def _local_gate(self, acceptor, transitions) -> None:
        """Raise for a LocalTransition configuration the port does not
        serve: models whose transitions differ (type or ``LOCAL_SHARED``
        setting: the JAX package's per-model refits share one traced
        configuration, ``smc.py:1621-1639``, so it runs them on its host
        loop, ROADMAP item 16), or an acceptor other than the uniform one
        (queue A, item 12). A constant, listed or bounded adaptive size and
        several models are served (an unbounded adaptive size is refused
        with the strategy)."""
        first = transitions[0]
        for tr in transitions:
            if type(tr) is not LocalTransition or any(
                    getattr(tr, a) != getattr(first, a)
                    for a in self.LOCAL_SHARED):
                raise _not_ported(
                    "LocalTransition with several models whose transitions "
                    "differ (the fused path refits every model with one "
                    "configuration; the JAX package serves them on its "
                    "host loop)", "16")
        if type(acceptor) is not UniformAcceptor:
            raise _not_ported(f"LocalTransition with a "
                              f"{type(acceptor).__name__}", "12")

    def _refit_cadence_cfg(self, n_cap: int) -> tuple | None:
        """(refit_every, drift_threshold) of LocalTransition's refit
        cadence, or None (refit every generation): auto is 16 from a
        population capacity of 16384 (the scale lane), else 1; an MVN
        transition never takes the cadence."""
        if type(self.transitions[0]) is not LocalTransition:
            return None
        every = self.refit_every
        if every is None:
            every = 16 if n_cap >= 16384 else 1
        if every <= 1:
            return None
        return (int(every), float(self.refit_drift_threshold))

    @property
    def model_names(self) -> list[str]:
        return [m.name for m in self.models]

    # ---------------------------------------------------------- lifecycle
    def new(self, db: str, observed_sum_stat: dict | None = None, *,
            gt_model: int | None = None, gt_par: dict | None = None,
            meta_info: dict | None = None,
            store_sum_stats: bool | int = True) -> History:
        """Open a new run in ``db`` and store the observed data."""
        if not observed_sum_stat:
            raise ValueError("observed summary statistics are required")
        self.x_0 = {k: np.asarray(v) for k, v in observed_sum_stat.items()}
        self.spec = SumStatSpec(self.x_0)
        self.history = History(db, store_sum_stats=store_sum_stats)
        options = dict(meta_info or {})
        options["parameter_names"] = {
            m: list(p.space.names) for m, p in enumerate(self.priors)}
        self.history.store_initial_data(
            gt_model, options, self.x_0, gt_par or {}, self.model_names,
            json.dumps(self.distance_function.get_config()),
            json.dumps(self.eps.get_config()),
            json.dumps(self.population_strategy.get_config()))
        return self.history

    def load(self, *args, **kwargs):
        raise _not_ported("resuming a stored run", "7")

    # ---------------------------------------------------------------- run
    def run(self, minimum_epsilon: float | None = None,
            max_nr_populations: float = np.inf,
            min_acceptance_rate: float = 0.0,
            max_total_nr_simulations: float = np.inf,
            max_walltime: datetime.timedelta | float | None = None
            ) -> History:
        if self.history is None:
            raise RuntimeError("call .new(db, observed) first")
        if self.history.max_t >= 0:
            raise _not_ported("continuing a run that already has "
                              "generations", "7")
        if isinstance(max_walltime, datetime.timedelta):
            max_walltime = max_walltime.total_seconds()
        self.generation_log = []
        self.capability_fallbacks = []
        self.sync_ledger.reset()
        if minimum_epsilon is None:
            # the JAX package's default: a temperature schedule stops at
            # T = 1 (the exact posterior), a threshold runs to the others
            minimum_epsilon = 1.0 if type(self.eps) is Temperature else 0.0
        w0 = len(self.history.write_seconds)
        self._run_fused(
            minimum_epsilon=float(minimum_epsilon),
            max_nr_populations=max_nr_populations,
            min_acceptance_rate=float(min_acceptance_rate),
            max_total_nr_simulations=max_total_nr_simulations,
            max_walltime=max_walltime)
        t_flush = time.perf_counter()
        self.history.done()
        self.flush_s = time.perf_counter() - t_flush
        written = dict(self.history.write_seconds[w0:])
        for entry in self.generation_log:
            entry["write_s"] = written.get(entry["t"], 0.0)
        return self.history

    # ------------------------------------------------------------- setup
    def _n_max(self) -> int:
        """The largest n of the run, which sizes the reservoir, the round
        and the round cap: the list's, or ``max(start,
        max_population_size)`` of an adaptive size (``smc.py:2183-2201``
        of the JAX package)."""
        ps = self.population_strategy
        if isinstance(ps, ListPopulationSize):
            return max(ps.values)
        if isinstance(ps, AdaptivePopulationSize):
            return max(ps(0), int(ps.max_population_size))
        return ps(0)

    def _adaptive_n_cfg(self, n_cap: int) -> tuple | None:
        """K16's ``(mean_cv, min_n, max_n, n_bootstrap)``, max_n the cap
        clipped to the reservoir, or None without an adaptive size."""
        ps = self.population_strategy
        if not isinstance(ps, AdaptivePopulationSize):
            return None
        return (float(ps.mean_cv), int(ps.min_population_size),
                int(min(ps.max_population_size, n_cap)),
                int(ps.n_bootstrap))

    def _build_context(self, n: int, min_acceptance_rate: float):
        d = self.distance_function
        d.initialize(self.spec)
        adaptive = bool(getattr(d, "adaptive", False))
        temp_config = None
        if self.stochastic:
            self.acceptor._kernel = d
            temp_config = device_config(self.eps, d, self.acceptor)
        n_cap = pow2_bucket(n, 64)
        B = pick_batch(n)
        rec_cap = (pow2_bucket(max(8 * n_cap, 1), 256)
                   if adaptive or self.stochastic else 0)
        max_rounds = self.MAX_ROUNDS
        if min_acceptance_rate > 0:
            max_rounds = max(1, min(max_rounds,
                                    int(n / min_acceptance_rate) // B + 1))
        x0 = torch.as_tensor(self.spec.flatten_host(self.x_0),
                             dtype=torch.float32, device=self.device)
        models = {}
        local = type(self.transition) is LocalTransition
        if local:
            # each model's neighbour rule at the run's largest n (JAX
            # smc.py:2344-2368 with n_max, :2795); the context builds each
            # model's k table once
            models["local_statics"] = [
                tr.fit_statics(n, p.dim)
                for tr, p in zip(self.transitions, self.priors)]
        if self.K > 1:
            models.update(
                models=self.models, priors=self.priors,
                model_prior=self.model_prior_probs,
                mpk=self.model_perturbation_kernel.device_params(),
                fit_statics=(models.get("local_statics") if local else
                             [tr.fit_statics() for tr in self.transitions]))
        return DeviceContext(
            model=self.model, prior=self.prior, distance=d,
            acceptor=self.acceptor, transition=self.transition,
            spec=self.spec, x0=x0, device=self.device,
            generator=self.generator, B=B, n_cap=n_cap, rec_cap=rec_cap,
            max_rounds=max_rounds, sync_ledger=self.sync_ledger,
            seed=self.seed, temp_config=temp_config, **models)

    # ------------------------------------------------------ early reject
    def _early_reject_incapable_reason(self, *, adaptive: bool,
                                       stochastic: bool) -> str | None:
        """Why the JAX package's segmented engine would not serve this
        configuration (None = it would), in the JAX package's words: every
        reason names the path that serves the configuration instead."""
        reason = uniform_protocol_reason(self.models)
        if reason is not None:
            return (f"{reason}; the classic full-trajectory kernel "
                    f"serves this config — declare "
                    f"TorchModel(segmented=...) to enable early reject")
        if self.spec is None:
            return "no SumStatSpec yet (run not initialized)"
        d = self.distance_function
        bound = d.device_bound_fn(self.spec)
        host = self._sumstat_host
        if bound is not None and host is not None and not host["seeds"]:
            # the JAX package gates after its generation-0 fit, and a
            # predictor generation 0 did not fit has no bound
            bound = None
        if bound is None:
            if stochastic:
                return (f"{type(d).__name__} has "
                        f"no monotone log-density upper bound "
                        f"(device_bound_fn); the classic kernel serves "
                        f"it — elementwise-separable kernels "
                        f"(IndependentNormal/IndependentLaplace, "
                        f"log-scale Binomial/Poisson) bound soundly")
            return (f"{type(d).__name__} has no "
                    f"monotone prefix bound (device_bound_fn); the "
                    f"classic kernel serves it — p-norm-family "
                    f"distances bound soundly")
        upper = bool(bound.get("upper", False))
        if stochastic and not upper:
            return (f"{type(d).__name__}'s prefix "
                    f"bound is a distance LOWER bound; stochastic "
                    f"retirement needs a log-density UPPER bound "
                    f"(acceptance provably impossible at the lane's "
                    f"pre-committed draw) — the classic kernel serves "
                    f"this config")
        if not stochastic and upper:
            return ("a log-density upper bound only decides the "
                    "StochasticAcceptor's test; deterministic accepts "
                    "keep the classic kernel")
        if host is not None:
            return (f"learned summary statistics without a device-"
                    f"fit plan mix trajectory entries across the "
                    f"prefix with host-refit parameters — no sound "
                    f"per-segment bound ({host['reason']}); the "
                    f"classic kernel serves this config")
        if stochastic and type(self.eps) is Temperature and any(
                type(sch).__name__ == "AcceptanceRateScheme"
                for sch in self.eps._effective_schemes()):
            return ("the AcceptanceRateScheme reweights the record "
                    "ring of ALL evaluations, but under early reject "
                    "the ring holds completed evaluations only — the "
                    "temperature would be survivor-biased; the classic "
                    "kernel serves this scheme")
        if adaptive and not d.sharded_scale_capable():
            scale_name = d.scale_function.__name__
            return (f"adaptive scale function {scale_name!r} has "
                    f"no moment-decomposable reduction, and under "
                    f"early reject the completed-only record ring "
                    f"is survivor-biased — unbiased refits need "
                    f"per-column moments over resolved lanes; the "
                    f"classic kernel serves this config (switch to "
                    f"{', '.join(sorted(SHARDED_SCALE_NAMES))} for "
                    f"early reject)")
        if adaptive and getattr(d, "aggregated", False):
            return ("adaptive refits under retirement accumulate "
                    "per-column moments over RAW sum-stat columns; "
                    "derived record-column transforms "
                    "(AdaptiveAggregatedDistance sub-distances) "
                    "read whole rows — the classic kernel serves "
                    "this config")
        for w in getattr(d, "weights", {}).values():
            if np.any(np.asarray(w) < 0):
                return ("negative distance weights break the bound's "
                        "monotonicity; the classic kernel serves them")
        if getattr(d, "aggregated", False):
            if np.any(np.asarray(d.factors) < 0) or any(
                np.any(np.asarray(w) < 0) for w in d.weights.values()
            ) or any(
                np.any(np.asarray(w) < 0)
                for sub in d.distances
                for w in sub.weights.values()
            ):
                return ("negative aggregated-distance weights/factors "
                        "break the bound's monotonicity; the classic "
                        "kernel serves them")
        return None

    def _early_reject_unserved(self) -> str | None:
        """A configuration the JAX engine serves and the port's does not
        yet (ROADMAP queue A, item 13), or None."""
        if self.device.type != "cuda":
            return None
        kernels = [m.segmented.kernel for m in self.models]
        if any(k is None for k in kernels):
            return "a segmented model without a built-in CUDA step"
        if len({k[1].kind for k in kernels}) > 1:
            return "several segmented models of different built-in steps"
        return None

    def _segment_gate(self, ctx: DeviceContext, *, adaptive: bool,
                      stochastic: bool) -> bool:
        """Decide early reject for this run; True when it is on (and
        ``ctx.seg_cfg`` is set)."""
        if self.early_reject is False:
            return False
        reason = self._early_reject_incapable_reason(
            adaptive=adaptive, stochastic=stochastic)
        if reason is None:
            if type(self.transition) is LocalTransition:
                raise _not_ported("segmented early reject with "
                                  "LocalTransition", "12")
            unserved = self._early_reject_unserved()
            if unserved is not None:
                raise _not_ported(f"segmented early reject with {unserved}",
                                  "13")
            ctx.seg_cfg = ctx.segment_cfg()
            return True
        if self.early_reject is True:
            raise ValueError(f"early_reject=True unavailable: {reason}")
        if any(getattr(m, "segmented", None) is not None
               for m in self.models):
            # only worth a record when the user built segmented models
            # (the JAX package's _note_capability_fallback)
            logger.info("segmented early reject off: %s", reason)
            self.capability_fallbacks.append({"gate": "early_reject",
                                              "reason": reason})
        return False

    def _health_config(self):
        if not self.health_checks:
            return None
        # the stall window arms only for schedules that adapt from the
        # data: quantile thresholds and temperature schemes
        adapts = isinstance(self.eps, QuantileEpsilon) or (
            self.stochastic and type(self.eps) is Temperature)
        stall_w = self.eps_stall_window if adapts else 0
        return (self.ess_floor, self.health_acc_floor, stall_w,
                self.eps_stall_rtol)

    def _scalar(self, value: float) -> torch.Tensor:
        return torch.tensor(float(value), dtype=torch.float32,
                            device=self.device)

    # -------------------------------------------------------- the loop
    def _run_fused(self, **kw) -> None:
        """The chunk loop, its generations persisted on the History's
        writer thread: the host path of a chunk is the fetch and a hand-over
        per generation, and the sqlite writes overlap the next chunk's
        device work. A failed loop drains what it handed over before the
        error propagates; ``run()``'s ``history.done()`` drains the rest."""
        self.history.start_async_writer()
        try:
            self._run_chunks(**kw)
        except BaseException:
            try:
                self.history.flush()
            except Exception:
                # the loop's error propagates; the write error stays on
                # the writer (re-raised by done()/close())
                logger.exception("the History writer also failed while "
                                 "draining")
            raise

    def _run_chunks(self, *, minimum_epsilon, max_nr_populations,
                    min_acceptance_rate, max_total_nr_simulations,
                    max_walltime) -> None:
        t_start = time.perf_counter()
        n = self.population_strategy(0)
        if type(self.eps) is Temperature:
            # the horizon the fixed-iteration schemes and the final T = 1
            # read (the host Temperature.initialize's max_nr_populations)
            self.eps._max_nr_populations = (
                int(max_nr_populations) if np.isfinite(max_nr_populations)
                else None)
        plan, host = self._sumstat_plan(n)
        #: learned statistics of either mode: generation 0 is a chunk of
        #: its own, fetched in float32
        learned = plan is not None or host is not None
        ctx = self._build_context(self._n_max(), min_acceptance_rate)
        ctx.host_refit = host is not None
        stochastic = ctx.stochastic
        adaptive_n = self._adaptive_n_cfg(ctx.n_cap)
        strategy = self.population_strategy
        d = self.distance_function
        adaptive = bool(getattr(d, "adaptive", False))
        seg_on = self._segment_gate(ctx, adaptive=adaptive,
                                    stochastic=stochastic)
        eps_quantile = isinstance(self.eps, QuantileEpsilon)
        local = type(self.transition) is LocalTransition
        if local:
            # the neighbour rule at the run's largest n, with the k table
            # the context put on the device once (K12 reads it)
            fit_statics = {**ctx.local_statics[0],
                           "k_table": ctx.local_configs[0]["k_table"]}
        else:
            fit_statics = self.transition.fit_statics()
        statics = dict(
            adaptive=adaptive, eps_quantile=eps_quantile,
            eps_weighted=getattr(self.eps, "weighted", True),
            alpha=getattr(self.eps, "alpha", 0.5),
            multiplier=getattr(self.eps, "quantile_multiplier", 1.0),
            fit_statics=fit_statics,
            health_config=self._health_config(),
            refit_cadence=self._refit_cadence_cfg(ctx.n_cap) if local
            else None, adaptive_n=adaptive_n)
        min_eps = self._scalar(minimum_epsilon)
        inf = math.inf
        carry = Carry(
            trans_params=self.transition.zero_params(ctx.n_cap, ctx.d,
                                                     self.device),
            fitted=torch.zeros((), dtype=torch.bool, device=self.device),
            dist_w=d.initial_weights(self.device),
            eps=self._scalar(0.0),
            hist_min=self._scalar(inf),
            eps_prev=self._scalar(inf),
            stall_count=torch.zeros((), dtype=torch.int32,
                                    device=self.device))
        if self.K > 1:
            self._model_carry(carry, ctx)
        if local:
            carry.gens_since = torch.zeros((), dtype=torch.int32,
                                           device=self.device)
        if adaptive_n is not None:
            # the first generation's n; K16 writes each next one
            carry.n_target = torch.full((), n, dtype=torch.int32,
                                        device=self.device)
        if isinstance(carry.dist_w, dict):
            # an IdentitySumstat's functions transform from the calibration
            # on
            ctx.learned = LEARNED_KERNELS[transform_kind(d.sumstat)]
        self.refit_events = []

        calib = None
        # the in-kernel scale machinery (K9, K25's refit) is the
        # calibration fit of an adaptive distance
        calib_w = isinstance(d, (AdaptivePNormDistance,
                                 AdaptiveAggregatedDistance))
        calib_eps = self.eps.requires_calibration()
        # a stochastic acceptor always calibrates: the first pdf norm (and
        # the first temperature) come from a prior sample, on the device
        if stochastic or calib_w or calib_eps:
            n_cal = (self.population_strategy.nr_calibration_particles or n)
            if n_cal > ctx.n_cap:
                raise ValueError(f"nr_calibration_particles {n_cal} exceeds "
                                 f"the reservoir ({ctx.n_cap})")
        if stochastic:
            temp0, pdf0, mf0, _run = ctx.calibrate_stochastic(
                int(n_cal), carry.dist_w)
            carry.eps, carry.daly_k = temp0, temp0
            carry.pdf_norm, carry.max_found = pdf0, mf0
            calib = {"temp0": temp0, "pdf_norm0": pdf0, "max_found0": mf0}
        elif calib_w or calib_eps:
            w0, eps0, _run = ctx.calibrate(
                int(n_cal), carry.dist_w, calib_w=calib_w,
                calib_eps=calib_eps, alpha=statics["alpha"],
                multiplier=statics["multiplier"])
            carry.dist_w = w0
            if eps0 is not None:
                carry.eps = eps0
            # the host mirrors the weights only where the calibration
            # refit them
            if isinstance(w0, dict):
                w0 = w0["w"]
            calib = {"eps0": carry.eps, **({"w0": w0} if calib_w else {})}

        G = self.fused_generations

        def chunk_limit(t: int) -> int:
            """The generations of the chunk that starts at ``t``: learned
            statistics run generation 0 as a chunk of its own (the host
            fit follows it)."""
            g = 1 if learned and t == 0 else G
            if np.isfinite(max_nr_populations):
                g = min(g, int(max_nr_populations) - t)
            if isinstance(self.eps, ListEpsilon):
                g = min(g, len(self.eps.epsilon_values) - t)
            if isinstance(strategy, ListPopulationSize):
                g = min(g, len(strategy.values) - t)
            return g

        # a user's per-generation weight schedule: each chunk's (G, P)
        # table of device params goes to the card in one copy
        weight_sched = not adaptive and self._weight_schedule_fused()
        fetch_dtype = fetch_dtype_of(self.fetch_dtype)
        t = 0
        sims_total = 0
        chunk_index = 0
        stop = False
        while not stop:
            g_limit = chunk_limit(t)
            if g_limit <= 0:
                break
            t_chunk = time.perf_counter()
            outs, host_gen = [], []
            sched = (self._schedule_table(t, g_limit) if weight_sched
                     else None)
            for g in range(g_limit):
                tg = t + g
                t_gen = time.perf_counter()
                syncs0 = self.sync_ledger.count
                if stochastic:
                    # a ListTemperature ladder comes from the host
                    host_eps = ctx.temp_config.fixed
                else:
                    host_eps = not eps_quantile or (tg == 0
                                                    and not calib_eps)
                if host_eps:
                    carry.eps = self._scalar(self.eps(tg))
                hist = carry.hist_min if ctx.use_hist else None
                at_min = carry.eps <= min_eps
                # the generation's distance params: its row of the
                # schedule table, else the carry's
                dw = sched[g] if sched is not None else carry.dist_w
                # learned statistics run generation 0 on the raw statistics
                # unsegmented (the JAX package samples it on the host)
                seg_g = seg_on and not (learned and tg == 0)
                if tg == 0:
                    def lanes(c=carry, h=hist, dw=dw, seg=seg_g):
                        return ctx.lanes_prior(c.eps, dw, h, t=0,
                                               pdf_norm=c.pdf_norm,
                                               segmented=seg)
                else:
                    def lanes(c=carry, h=hist, tg=tg, dw=dw):
                        return ctx.lanes_transition(
                            c.trans_params, c.eps, dw, h, t=tg,
                            pdf_norm=c.pdf_norm,
                            carry=c if self.K > 1 else None,
                            segmented=seg_on)
                # the generation's n: the device's under an adaptive size
                # (the host reads it with the first round's counters)
                n_gen = (carry.n_target if adaptive_n is not None
                         else strategy(tg))
                run = (ctx.generation_while_seg if seg_g
                       else ctx.generation_while)(lanes, n_gen,
                                                  eps_at_min=at_min)
                n_t = run.n_target
                gen_ok = run.n_acc >= min(n_t, ctx.n_cap)
                if not gen_ok:
                    logger.info("stopping: generation %d incomplete "
                                "(n_acc=%d/%d in %d rounds)", tg, run.n_acc,
                                n_t, run.rounds)
                    stop = True
                    break
                sims_total += run.n_valid
                acc_rate = n_t / max(run.n_valid, 1)
                # every stop rule reads host values of this generation's
                # counters, so it is known before the step: K16 is skipped
                # in the generation after which the run stops
                last = bool(
                    run.eps_at_min or tg + 1 >= max_nr_populations
                    or acc_rate < min_acceptance_rate
                    or sims_total >= max_total_nr_simulations
                    or (max_walltime is not None
                        and time.perf_counter() - t_start > max_walltime))
                # the inputs a host fit's boundary step reads: generation
                # 0's under a device-fit plan, each chunk's last in the
                # host-refit mode
                carry, out = ctx.generation_step(
                    carry, run, t=tg, last=last,
                    sumstat_fit=plan if g == g_limit - 1 else None,
                    keep_inputs=((plan is not None and tg == 0)
                                 or (host is not None and g == g_limit - 1)),
                    **statics)
                outs.append(out)
                host_gen.append({
                    "t": tg, "n": n_t, "rounds": run.rounds,
                    "n_valid": run.n_valid,
                    "n_acc": run.n_acc, "acceptance_rate": acc_rate,
                    "syncs": self.sync_ledger.count - syncs0,
                    "compute_s": time.perf_counter() - t_gen})
                if last:
                    stop = True
                    break
            if not outs:
                break
            t_fetch = time.perf_counter()
            n_keep = max(info["n"] for info in host_gen)
            # the raw rows a host fit reads ride the fetch in float32:
            # generation 0's under a plan, the last generation's of every
            # chunk in the host-refit mode (which fetches float32 only)
            raw_fit = (plan is not None and t == 0) or host is not None
            dtype = (torch.float32 if raw_fit or (learned and t == 0)
                     else fetch_dtype)
            fetched = self._fetch_chunk(outs, t, n_keep, dtype, adaptive,
                                        calib if chunk_index == 0 else None,
                                        stochastic, raw_gen=len(outs) - 1
                                        if raw_fit else None)
            for info in host_gen:
                info["fetch_s"] = (time.perf_counter() - t_fetch) / len(outs)
            # a host fit's boundary (a plan's seed fit after generation 0,
            # the host-refit mode's after every chunk): the fit before the
            # chunk's last generation is persisted (the host-refit mode's
            # telemetry records it), the device step after
            boundary, boundary_tel = False, None
            if (raw_fit and not stop and chunk_limit(t + len(outs)) > 0):
                boundary, boundary_tel = self._host_update(fetched, host_gen,
                                                           t, adaptive)
                if plan is not None and not boundary:
                    raise RuntimeError("the generation-0 seed fit did not "
                                       "run")
            chunk_s = time.perf_counter() - t_chunk
            n_kept, single = self._persist_chunk(
                fetched, host_gen, t, chunk_index, chunk_s, eps_quantile,
                adaptive, plan, host, boundary_tel if host else None)
            stop = stop or single
            if boundary:
                self._host_transform(ctx, carry, outs[-1], t + n_kept - 1,
                                     statics)
            t += n_kept
            chunk_index += 1

    def _sumstat_plan(self, n0: int) -> tuple[dict | None, dict | None]:
        """The learned statistic's modes for this run -> (the device-fit
        plan, the host-refit mode), at most one of them set (both None
        without a statistic). Generation 0 runs under the identity, so a
        predictor must start unfitted: one fitted already (by the user, by
        ``convert.sumstat_from_jax`` or by an earlier run: the JAX package
        would transform the calibration and generation 0 with it and refit
        on its ``fit_every`` cadence) raises before launch, as does a shape
        beyond the transform kernels. A configuration without a plan, or
        whose generation 0 cannot seed the plan's fit, runs the host-refit
        mode, recorded as the JAX package does (the ``sumstat_device``
        capability fallback with its reason)."""
        self._sumstat_host = None
        d = self.distance_function
        ss = getattr(d, "sumstat", None)
        if ss is None:
            return None, None
        if isinstance(ss, PredictorSumstat) and (
                ss.predictor.fitted or ss._last_fit_t is not None):
            raise _not_ported(
                "learned summary statistics whose predictor is fitted "
                "before the run (generation 0 under that transform)", "14")
        S = self.spec.total_size
        reason = host_caps_reason(ss, S, self.prior.dim)
        if reason is not None:
            raise _not_ported(reason, "14")
        plan, reason = device_fit_plan(d, total_size=S,
                                       d_max=self.prior.dim)
        if plan is not None and n0 < plan["need"]:
            plan, reason = None, (
                "the generation-0 host fit did not seed the "
                "predictor (min_samples not reached), so the "
                "carried parameter structure and C' dimension are "
                "unfixed; the host-refit path serves this run")
        if plan is not None:
            return plan, None
        logger.info("device-native sumstat fit off: %s", reason)
        self.capability_fallbacks.append({"gate": "sumstat_device",
                                          "reason": reason})
        self._sumstat_host = {
            "reason": reason,
            "seeds": isinstance(ss, PredictorSumstat) and n0 >= ss.need(S)}
        return None, self._sumstat_host

    def _bind_predictor(self, sumstat) -> None:
        """A fit that trains on the device (an MLP's, a model selection's
        MLP candidate's) runs on this run's device and records its read in
        this run's ledger."""
        for pred in {id(p): p for p in [getattr(sumstat, "predictor", None),
                                        *candidates(sumstat)]
                     if p is not None}.values():
            pred.device, pred.sync_ledger = self.device, self.sync_ledger

    def _population(self, fetched: dict, g: int, n: int) -> Population:
        """Generation g of a fetched chunk as a host population (the raw
        statistics of a generation whose rows rode the fetch)."""
        theta, dist, logw = unpack_rows(fetched["rows"], self.prior.dim)
        return Population(
            ms=np.zeros(n, np.int32), thetas=theta[g][:n],
            weights=exp_normalize_log_weights(logw[g][:n]),
            distances=dist[g][:n],
            sumstats=fetched["sumstats"][fetched["ss_gens"].index(g)][:n],
            spaces=[self.prior.space], sumstat_spec=self.spec,
            model_names=self.model_names)

    @staticmethod
    def _eps_statics(statics: dict) -> dict:
        return {k: statics[k] for k in ("adaptive", "eps_quantile",
                                        "eps_weighted", "alpha",
                                        "multiplier")}

    def _mirror_boundary_weights(self, carry: Carry, t: int,
                                 kind: str) -> None:
        """One read of a boundary's adaptive weights into ``weights[t]``."""
        w = (carry.dist_w["w"] if isinstance(carry.dist_w, dict)
             else carry.dist_w)
        d = self.distance_function
        d.weights[t] = d.host_weights(self._to_host({"w": w}, kind)["w"])

    def _host_update(self, fetched: dict, host_gen: list, t0: int,
                     adaptive: bool) -> tuple[bool, dict]:
        """The host part of a boundary after a chunk (``dispatch.py:880-905``
        of the JAX package; a device-fit plan's seed fit after generation
        0): ``update(t, pop)`` on the chunk's last population, its raw rows
        in float64, at the JAX package's ``t`` (the next chunk's first
        generation; ``fit_every`` counts in it) -> (whether the device step
        follows: the transform changed, or an adaptive distance refits at
        a boundary after generation 0 as the JAX package's always does,
        the telemetry of the chunk's last generation in the host-refit
        mode: ``sumstat_refit`` where the fit ran, and the JAX package's
        ``distance_changed`` at a boundary after generation 0). A
        generation whose health word failed is left to the persist, which
        raises for it. The predictor trains on this run's device and
        records a read of its result in this run's ledger."""
        g = len(host_gen) - 1
        t_last = t0 + g
        if "health" in fetched and int(fetched["health"][g]) != 0:
            return False, {}
        ss = self.distance_function.sumstat
        self._bind_predictor(ss)
        changed = ss.update(t_last + 1, self._population(
            fetched, g, host_gen[g]["n"]))
        tel = {"sumstat_refit": True} if changed else {}
        if t_last > 0:
            tel["distance_changed"] = True
        return changed or (adaptive and t_last > 0), tel

    def _host_transform(self, ctx: DeviceContext, carry: Carry, out: dict,
                        t_last: int, statics: dict) -> None:
        """The device part of a host fit's boundary after generation
        ``t_last``: the statistic's current transform (a new fit's, or the
        one in effect) goes to the card, with the adaptive weights refit in
        its space (over the record ring after generation 0, over the
        accepted rows later), the distances and the epsilon
        (``DeviceContext.boundary_transform``); an adaptive distance's
        weights are read back once for the host mirror (``sumstat_seed``
        after generation 0, ``sumstat_boundary`` later). The kind may
        change (a model selection's winner): the rounds then run the new
        kind's kernel."""
        ss = self.distance_function.sumstat
        ctx.boundary_transform(
            carry, out, ss.device_params(self.device),
            kind=transform_kind(ss), ring=t_last == 0, t_next=t_last + 1,
            **self._eps_statics(statics))
        if statics["adaptive"]:
            self._mirror_boundary_weights(
                carry, t_last + 1,
                "sumstat_seed" if t_last == 0 else "sumstat_boundary")

    def _weight_schedule_fused(self) -> bool:
        """True when the (non-adaptive) distance carries a user's
        per-generation weight schedule (``PNormDistance(weights={t: ...})``,
        ``AggregatedDistance`` top-level or sub-distance schedules), as
        the JAX package's twin."""
        d = self.distance_function
        if type(d) in (PNormDistance, AggregatedDistance):
            return d.schedule()
        return False

    def _schedule_table(self, t0: int, g_limit: int) -> torch.Tensor:
        """The chunk's ``(G, P)`` float32 table of ``device_params(t0 +
        g)``, the rows after the chunk's last generation repeating it;
        one host-to-device copy, nothing read back."""
        d = self.distance_function
        last = max(g_limit - 1, 0)
        table = torch.stack([d.device_params(t0 + min(g, last))
                             for g in range(self.fused_generations)])
        if self.device.type != "cuda":
            return table
        return table.pin_memory().to(self.device, non_blocking=True)

    def _model_carry(self, carry: Carry, ctx: DeviceContext) -> None:
        """K > 1: stacked never-fitted params and the model terms of the
        first transition generation's placeholders (generation 0 proposes
        from the priors and reads none of them)."""
        dev, f32 = self.device, torch.float32
        K = self.K
        cls = (LocalTransition if ctx.local
               else MultivariateNormalTransition)
        carry.trans_params = cls.zero_params_models(K, ctx.n_cap, ctx.d,
                                                    ctx.dims_f)
        carry.fitted = torch.zeros(K, dtype=torch.bool, device=dev)
        carry.log_model_probs = ctx.model_logits.clone()
        carry.matrix = torch.zeros(K, K, dtype=f32, device=dev)
        carry.log_model_factor = torch.zeros(K, dtype=f32, device=dev)

    # ------------------------------------------------------ fetch/persist
    def _fetch_chunk(self, outs, t0, n, dtype, adaptive, calib,
                     stochastic, raw_gen: int | None = None) -> dict:
        """Pack the chunk's generations and read them in one sync: the
        first ``n`` rows of each (the chunk's largest n; each generation
        keeps its own when persisted). ``raw_gen``: the generation whose
        raw rows a host fit reads (generation 0 under a device-fit plan,
        each chunk's last in the host-refit mode), on the fetch whatever
        History stores."""
        each = lambda k: [o[k] for o in outs]  # noqa: E731
        stack = lambda k: torch.stack(each(k))  # noqa: E731
        tree = {
            # K10 reads each generation's reservoir in place
            "rows": pack_rows(each("theta"), each("distance"),
                              each("log_weight"), n_keep=n, dtype=dtype),
            "eps_used": stack("eps_used"),
            "eps_next": stack("eps_next"),
        }
        ss_gens = [g for g in range(len(outs))
                   if g == raw_gen or self.history.wants_sum_stats(t0 + g)]
        if ss_gens:
            tree["sumstats"] = pack_sumstats(
                [outs[g]["sumstats"] for g in ss_gens], n_keep=n,
                dtype=dtype)
        if adaptive:
            # learned statistics: the feature weights of {"w", "ss"}
            tree["dist_w_next"] = torch.stack([
                dw["w"] if isinstance(dw, dict) else dw
                for dw in each("dist_w_next")])
        if "ss_fit" in outs[-1]:
            # the boundary generation's fitted transform (an MLP's layers
            # packed) and K23's flags
            fit = dict(outs[-1]["ss_fit"])
            if "layers" in fit:
                fit["layers"] = pack_layers(fit["layers"])
            tree.update({f"ss_fit_{k}": v for k, v in fit.items()})
            tree["fit_flags"] = outs[-1]["fit_flags"]
        if "m" in outs[0]:
            # K > 1: each kept row's model (int8) and the model
            # probabilities, in the same fetch
            tree["m"] = pack_models(each("m"), n_keep=n)
            tree["model_probs"] = stack("model_probs")
        if stochastic:
            for k in ("pdf_norm_next", "max_found_next", "daly_k_next"):
                tree[k] = stack(k)
        if "health" in outs[0]:
            tree["health"] = stack("health")
            tree["ess"] = stack("ess")
        if "seg" in outs[0]:
            # K18's counters ride the same fetch: no extra sync
            tree["seg"] = stack("seg")
        if "refit" in outs[0]:
            # so do LocalTransition's refit decisions, drifts and rows
            for k in ("refit", "drift", "rows_changed"):
                tree[k] = stack(k)
        if "n_next" in outs[0]:
            # and K16's next n, its probes and its CV at max_n
            for k in ("n_next", "k16_probes", "k16_cv_max"):
                tree[k] = stack(k)
        if calib is not None:
            tree.update({f"calib_{k}": v for k, v in calib.items()})
        host = self._to_host(tree)
        host["ss_gens"] = ss_gens
        return host

    def _to_host(self, tree: dict, kind: str = "chunk_fetch") -> dict:
        """One device -> host read of every tensor of ``tree``, recorded in
        the sync ledger as ``kind``."""
        out, nbytes = {}, 0
        cuda = self.device.type == "cuda"
        for k, v in tree.items():
            if cuda:
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
            else:
                h = v.detach().clone()
            out[k] = h
            nbytes += v.numel() * v.element_size()
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        self.sync_ledger.record(kind, nbytes)
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in out.items()}

    def _persist_chunk(self, fetched, host_gen, t0, chunk_index, chunk_s,
                       eps_quantile, adaptive, plan: dict | None = None,
                       host: dict | None = None,
                       boundary_tel: dict | None = None) -> tuple[int, bool]:
        """Persist the chunk's generations -> (how many were persisted,
        whether stop_if_only_single_model_alive stopped the run there).
        ``boundary_tel``: the telemetry of a host-refit boundary, on the
        chunk's last generation."""
        if "calib_pdf_norm0" in fetched:
            self._mirror_noisy(-1, fetched["calib_pdf_norm0"],
                               fetched["calib_max_found0"],
                               fetched["calib_temp0"])
        if "calib_w0" in fetched:
            self.distance_function.weights[0] = (
                self.distance_function.host_weights(fetched["calib_w0"]))
        if ("calib_eps0" in fetched and eps_quantile
                and self.eps.requires_calibration()):
            self.eps._values[0] = float(fetched["calib_eps0"])
        d = max(p.dim for p in self.priors)
        theta, dist, logw = unpack_rows(fetched["rows"], d)
        spaces = [p.space for p in self.priors]
        for g, info in enumerate(host_gen):
            t, n = t0 + g, info["n"]
            if "health" in fetched and int(fetched["health"][g]) != 0:
                raise DegenerateRunError(t, int(fetched["health"][g]))
            eps_used = float(fetched["eps_used"][g])
            ss = None
            if g in fetched["ss_gens"]:
                ss = fetched["sumstats"][fetched["ss_gens"].index(g)][:n]
            ms = (fetched["m"][g][:n].astype(np.int32) if "m" in fetched
                  else np.zeros(n, np.int32))
            # the writer thread holds the population until it is written;
            # it views none of the chunk's pinned buffers: unpack_rows
            # copies, and Population casts the sum stats to float64
            pop = Population(
                ms=ms, thetas=theta[g][:n],
                weights=exp_normalize_log_weights(logw[g][:n]),
                distances=dist[g][:n], sumstats=ss, spaces=spaces,
                sumstat_spec=self.spec, model_names=self.model_names)
            telemetry = {
                "fused_chunk": len(host_gen), "chunk_index": chunk_index,
                "chunk_s": round(chunk_s, 4), "rounds": info["rounds"],
                "n_evaluations": info["n_valid"],
                "acceptance_rate": round(info["acceptance_rate"], 6),
                "syncs": info["syncs"],
                "device": str(self.device), "n_target": n,
            }
            if t == 0 and self.capability_fallbacks:
                telemetry["capability_fallbacks"] = [
                    dict(f) for f in self.capability_fallbacks]
            if plan is not None:
                telemetry.update(self._sumstat_telemetry(
                    fetched, t, g == len(host_gen) - 1, plan))
            elif host is not None and t == 0:
                telemetry["sumstat"] = self._host_sumstat_block()
            if boundary_tel and g == len(host_gen) - 1:
                telemetry.update(boundary_tel)
            if "health" in fetched:
                telemetry["health"] = int(fetched["health"][g])
                telemetry["ess"] = float(fetched["ess"][g])
            if "refit" in fetched:
                event = (t, bool(fetched["refit"][g]),
                         float(fetched["drift"][g]),
                         int(fetched["rows_changed"][g]))
                self.refit_events.append(event)
                telemetry.update(refit=event[1], drift=round(event[2], 5),
                                 refit_rows_changed=event[3])
            if "n_next" in fetched:
                # the device's decision, mirrored into the host strategy
                n_next = int(fetched["n_next"][g])
                telemetry["n_next"] = n_next
                self.population_strategy.nr_particles = n_next
                probes = int(fetched["k16_probes"][g])
                if probes:
                    telemetry.update(
                        k16_probes=probes,
                        k16_cv_max=float(fetched["k16_cv_max"][g]))
            if "seg" in fetched:
                ret, steps, resolved, slots = (
                    int(v) for v in fetched["seg"][g])
                telemetry.update(
                    retired_early=ret,
                    segment_occupancy=round(float(occupancy(steps, slots)),
                                            4),
                    seg_steps=steps, seg_resolved=resolved)
            t_persist = time.perf_counter()
            self.history.append_population_async(
                t, eps_used, pop, info["n_valid"], self.model_names,
                telemetry)
            info = {**info, "persist_s": time.perf_counter() - t_persist}
            if eps_quantile:
                self.eps._values[t] = eps_used
                self.eps._values[t + 1] = float(fetched["eps_next"][g])
            if adaptive:
                self.distance_function.weights[t + 1] = (
                    self.distance_function.host_weights(
                        fetched["dist_w_next"][g]))
            if "pdf_norm_next" in fetched:
                self._mirror_noisy(
                    t, fetched["pdf_norm_next"][g],
                    fetched["max_found_next"][g], fetched["eps_next"][g],
                    fetched["daly_k_next"][g])
            self.generation_log.append({**info, "eps": eps_used,
                                        "chunk_s": chunk_s,
                                        "chunk_index": chunk_index})
            logger.info("t: %d, eps: %.8g, acceptance rate: %.5f (%d "
                        "evaluations)", t, eps_used,
                        info["acceptance_rate"], info["n_valid"])
            if "model_probs" in fetched:
                # the host rule of the JAX package (smc.py:1558), read from
                # the fetched model probabilities; the chunk's later
                # generations are not persisted
                self.model_probs = {
                    m: float(p) for m, p in
                    enumerate(fetched["model_probs"][g]) if p > 0}
                if (self.stop_if_only_single_model_alive
                        and len(self.model_probs) == 1):
                    logger.info("stopping: single model alive")
                    return g + 1, True
        return len(host_gen), False

    def _sumstat_telemetry(self, fetched, t, boundary, plan) -> dict:
        """Learned statistics' telemetry of generation t, and the mirror of
        a boundary fit: the first generation gets the JAX package's
        ``sumstat`` block (``smc.py:1841-1864``); a boundary generation
        whose fit ran (K23's own flag, fetched with the chunk) mirrors the
        fetched parameters into the predictor (``_last_fit_t = t + 1``)
        and reports the fit's finite flag."""
        tel = {}
        if t == 0:
            tel["sumstat"] = {
                "mode": "device", "transform": type(
                    self.distance_function.sumstat).__name__,
                "dim_raw": int(self.spec.total_size), "kind": plan["kind"],
                "dim_reduced": int(plan["out_dim"]),
                "need": int(plan["need"])}
        if boundary and "fit_flags" in fetched and fetched["fit_flags"][1]:
            keys = [k[len("ss_fit_"):] for k in fetched
                    if k.startswith("ss_fit_")]
            ssp = {k: fetched[f"ss_fit_{k}"] for k in keys}
            if "layers" in ssp:
                pred = self.distance_function.sumstat.predictor
                sizes = (self.spec.total_size, *pred.hidden,
                         plan["out_dim"])
                ssp["layers"] = unpack_layers(
                    torch.from_numpy(ssp["layers"]), sizes)
            mirror_fitted_params(self.distance_function, ssp, t + 1)
            tel.update(sumstat_refit=True,
                       sumstat_fit_ok=bool(fetched["fit_flags"][0]))
        return tel

    def _host_sumstat_block(self) -> dict:
        """The host-refit mode's ``sumstat`` telemetry of generation 0 (the
        JAX package's ``_sumstat_telemetry`` without a plan): the mode,
        the statistic, S and, once a fit fixed it, C'."""
        ss = self.distance_function.sumstat
        block = {"mode": "host", "transform": type(ss).__name__,
                 "dim_raw": int(self.spec.total_size)}
        if getattr(ss, "_out_dim", None):
            block["dim_reduced"] = int(ss._out_dim)
        return block

    def _mirror_noisy(self, t, pdf_norm, max_found, temp,
                      daly_k=None) -> None:
        """Mirror generation t + 1's device noisy-ABC state into the host
        objects (t = -1: the calibration's, for generation 0); a
        ListTemperature ladder is already authoritative."""
        self.acceptor.pdf_norms[t + 1] = float(pdf_norm)
        if np.isfinite(float(max_found)):
            self.acceptor._max_found = max(self.acceptor._max_found,
                                           float(max_found))
        if type(self.eps) is not Temperature:
            return
        self.eps.temperatures[t + 1] = float(temp)
        if daly_k is not None:
            for sch in self.eps._effective_schemes():
                if type(sch).__name__ == "DalyScheme":
                    sch._k[t + 1] = float(daly_k)
