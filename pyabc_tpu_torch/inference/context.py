"""The device side of a fused single-device run
(``pyabc_tpu/inference/util.py::DeviceContext`` counterpart, main branch).

One generation is a host loop of proposal rounds. Each round runs on the
device: the proposal (K2 with its own Philox numbers, K1: prior draw, or
weighted ancestor + MVN perturbation with ``N_REDRAWS`` redraws against
zero prior mass), the proposal density (K3), the simulator (K4 for
Lotka-Volterra, K20 for SIR, their noise drawn from Philox too), distance /
accept / log-weight (K5) and the compaction into the slot-ordered
reservoir and the record ring (K6). The host then reads the round counters
once; that read is the round's only sync. After the last round the
generation step (weight normalization and the quantile epsilon K7, the
adaptive refit K9, the MVN refit K8, the health word K11) runs on the
device with no host read at all: epsilon, distance weights and transition
parameters stay device tensors from one generation to the next.

Noisy ABC (a ``StochasticAcceptor`` with a temperature epsilon,
``pyabc_tpu`` ``multigen_kernel(stochastic=True)``): a round's kernel
value, accept test and log weight come from K21a in place of K5, with the
temperature and the pdf norm as device scalars and each lane's uniform on
the accept stream; the record ring also keeps each record's theta and
proposal log-density (K6's record mode). The generation step skips the
quantile, evaluates the ring under the refit transition (K3) and runs K21b,
which updates the pdf norm, the running maximum, Daly's k and the
temperature on the device. The calibration gives the first norm and
temperature from its sample through K21b too, so no temperature is ever
read back to the host. The temperature rides ``Carry.eps``.

A run over several models (K > 1, ``multigen_kernel`` with K models; the
fused, single-device, non-stochastic path): each lane first draws its model
on the MODEL stream inside K2 (from the model prior at generation 0 and in
calibration, else an ancestor model from the last population's model
probabilities, perturbed by the masked perturbation matrix), then theta
from that model's prior or fit (stacked ``(K, ...)`` params, theta padded
to d_max with exact zeros); K3 scores each lane under its own model's
mixture; the model family's simulator (K20b) or each user model under a
``torch.where`` simulates; K5 adds the model prior and the log model
factor to the log weight; K6 keeps each row's model. The generation step
runs K26 (model probabilities, counts, the fitted mask, and the next
generation's matrix and log model factor) and the per-model K8 refit, one
launch over all models. Nothing of it is read by the host before the
chunk's fetch.

Segmented early reject (``pyabc_tpu`` ``_generation_while_seg``, a p-norm
distance, a uniform acceptor): a round's slots are proposed by K2 and K3
as above, then K18 takes the simulator's place. It steps each slot one
segment at a time with the model's built-in step (K19 or K20b; K > 1: each
slot its own model's descriptor), folds the p-norm's prefix bound and
retires a slot, between segments, once the bound proves it rejected; a
thread whose slot retires takes the next slot. K5 tests the complete slots
(its valid mask is K18's ``keep``; K > 1 with the lanes' models and model
terms) and K6 counts every valid slot as evaluated, so a generation
resolves whole rounds and its accepted rows, rounds and evaluations equal
the classic path's. The generation's K18 counters (retired, segments
stepped, slots resolved, lane-segment slots) stay on the device until the
chunk's fetch. Under an adaptive distance the record ring would hold
completed candidates only, so K22 folds every resolved slot's simulated
columns (a retired slot's prefix, from K18's ``nseg``) into the
generation's ``(6, S)`` moment block after each round, and the generation
step finishes the refit from it (K22's finish in K9's place); the
calibration keeps K9 over its complete prior sample.

An adaptive population size (``multigen_kernel(adaptive_n=...)``): the
generation's n lives in device memory (``Carry.n_target``) and rides the
round counters (slot ``N_TARGET``), so the host learns it at the first
round's read with no extra sync. After the refit K16 draws the bootstrap
ancestors once and runs a fixed number of probes (the bootstrap fits, the
density CV, a bisection step); the next n stays in device memory and
reaches the host in the chunk's fetch. A list of sizes sets the slot from
the host each generation.

LocalTransition (``pyabc_tpu`` ``multigen_kernel`` with a LocalTransition):
a round draws with K2's local mode (each ancestor's own Cholesky factor)
and scores with K14 (one Gaussian per component, in the diff form). The
generation step runs K15 (the drift of the accepted population against
the fitted one and the cadence's refit decision, left in device memory),
then K12 (the k-NN covariance field) and K13 (the factorization, of the
changed rows only under the cadence), both of which return at once when
K15's flag reads 0: the refit costs no host sync. Over several models
(identical LocalTransitions) K2 and K14 take their K > 1 local modes on
stacked params, K15 decides per model (each model's drift, the maximum,
the forced refit of a model with rows and no fit) and writes each model's
masked weights, K12 and K13 run once per model under that model's flag
(its k from its own count), and K26 masks the perturbation matrix with
K15's fitted mask. Under an adaptive population size K16 takes its
LocalTransition mode: each probe gathers the resampled rows, refits them
with K12 and K13 (their flag: the bisection is not done) and scores the
fitted particles under every refit.

An aggregated distance (``AggregatedDistance``, a weighted sum of plain
p-norms): ``Carry.dist_w`` is K25's flat params ``[W, w_1, ..., w_n]`` and
a round's distance, accept test and log weight come from K25's accept in
K5's place; under early reject K18 folds one prefix bound a sub-distance
(its aggregate mode). An adaptive aggregate refits W in the generation
step, and at calibration, with K25's refit in K9's place: the
sub-distances of the ring's rows, their column scale, ``W = factors /
scale`` and the reservoir's distances under it. A user's weight schedule
arrives as one row of the chunk's table per generation (``dist_w``).

Learned statistics (``PNormDistance`` or ``AdaptivePNormDistance`` with
``sumstat=PredictorSumstat(LinearPredictor(...))`` or ``MLPPredictor``,
the linear and MLP plans of ``pyabc_tpu``
``multigen_kernel(sumstat_fit=...)``): once the host seed fit after
generation 0 has run, ``Carry.dist_w`` is ``{"w": (C',), "ss": the
transform}`` and a round's accept is K23's for the plan's kind
(``linear_accept`` or ``mlp_accept``: x and x0 through the transform, then
K5's p-norm and epilogue); under early reject (the linear plan only) K18
folds the transformed bound (its ``LinBound``) on operands K18's prepare
kernel forms once a generation. At a chunk's boundary generation the
generation step runs K23's fit (``ridge_fit``, or ``mlp_fit``'s
warm-started Adam steps: the decision, the fit and its finite guard on
the device), then under an adaptive distance K9 over the record ring
transformed by the new parameters, else K23's values mode over the
reservoir, so the epsilon quantile is taken in the new feature space; the
generation's rows are transformed under the parameters they were accepted
with for the fetch (C' wide).

The host-refit mode (``host_refit``; Lasso, GP and model-selection
predictors, ``IdentitySumstat``, ``fit_every``): the rounds run the
current transform's kind (``LEARNED_KERNELS``: K23's linear or MLP
transform, the GP kernel, or K5 after an ``IdentitySumstat``'s functions,
which transform from the calibration on), the parameters stay constant
inside a chunk (an adaptive distance refits its weights over the
transformed ring, as in the JAX kernel), the fetch ships raw rows, and
after a host fit ``boundary_transform`` moves the carry to the new
parameters: the weights (over the accepted rows at a later boundary), the
distances and the epsilon.

Every draw of a round sits at a fixed place of the run's Philox stream:
key = the seed, counter = (lane, block, generation, tag * max_rounds +
round), the round read on the device from the counters. Calibration runs
as generation -1 (2^32 - 1), so its draws never meet generation 0's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..kernels import philox
from ..core.random_variables import stacked_arrays
from ..kernels.aggregate import aggregate_accept_weight
from ..kernels.bootstrap_cv import STEP, required_nr
from ..kernels.compact import compact_round
from ..kernels.gp_sumstat import gp_accept
from ..kernels.gp_sumstat import transform_rows as gp_transform_rows
from ..kernels.kernel_accept import kernel_accept
from ..kernels.linear_sumstat import linear_accept, transform_rows
from ..kernels.local_logpdf import local_logpdf
from ..kernels.mlp_fit import mlp_fit
from ..kernels.mlp_sumstat import mlp_accept
from ..kernels.mlp_sumstat import transform_rows as mlp_transform_rows
from ..kernels.model_step import model_step
from ..kernels.moments import moment_fold, seg_of_columns
from ..kernels.mvn_fit import mvn_fit
from ..kernels.mvn_logpdf import mvn_mixture_logpdf
from ..kernels.philox import PhiloxStream
from ..kernels.pnorm_accept import pnorm_accept_weight
from ..kernels.proposal_drift import proposal_drift
from ..kernels.propose import N_REDRAWS, propose, propose_local
from ..kernels.ridge_fit import ridge_fit
from ..kernels.segment_round import segment_round
from ..kernels.temperature_update import scheme_tables, temperature_update
from ..model import simulate_models_flat
from ..observability.sync import SyncLedger
from ..ops.health import generation_health
from ..ops.scale_reduce import init_moments
from ..ops.segment import uniform_protocol_reason
from ..ops.stats import normalize_log_weights, weighted_quantile
from ..sumstat.base import expand_rows, identity_accept
from ..transition.local_transition import LocalTransition

#: counters vector layout: n_acc, rounds, n_valid, eps <= min_eps, and the
#: generation's target n (the host reads it with the round's counters)
N_ACC, ROUNDS, N_VALID, EPS_AT_MIN, N_TARGET = range(5)
#: the generation index of the calibration rounds' draws
CALIBRATION_GENERATION = 2 ** 32 - 1
#: the (accept, transform) entries of a transform kind: K23's linear and
#: MLP ones (the device-fit plans, and the host-refit mode's linear, Lasso
#: and MLP predictors), the GP kernel's, and an ``IdentitySumstat``'s
#: functions before K5
LEARNED_KERNELS = {"linear": (linear_accept, transform_rows),
                   "mlp": (mlp_accept, mlp_transform_rows),
                   "gp": (gp_accept, gp_transform_rows),
                   "identity": (identity_accept, expand_rows)}


def quantile_epsilon(d, k_mask, w_norm, weighted: bool, alpha: float,
                     multiplier: float) -> torch.Tensor:
    """The next epsilon from the kept rows' distances: their (weighted)
    alpha-quantile times ``multiplier`` (K7)."""
    pts = torch.where(k_mask, d, torch.full_like(d, math.inf))
    wts = (torch.where(k_mask, w_norm, torch.zeros_like(w_norm)) if weighted
           else k_mask.to(torch.float32))
    return weighted_quantile(pts, wts, alpha) * multiplier


@dataclass
class Carry:
    """Device state carried from one generation to the next."""

    trans_params: dict          # K > 1: stacked over the models
    fitted: torch.Tensor        # bool (); K > 1: (K,)
    dist_w: torch.Tensor        # (S,); an aggregated distance's flat
    #                             params (K25); a stochastic kernel's
    #                             variances; a fitted learned statistic's
    #                             {"w": (C',), "ss": the transform}
    eps: torch.Tensor           # () threshold (temperature) of the next
    hist_min: torch.Tensor      # () running min of used epsilons
    eps_prev: torch.Tensor      # () health: previous epsilon
    stall_count: torch.Tensor   # () int32 health: stall counter
    # noisy ABC: the pdf norm, the largest kernel value found, Daly's k
    pdf_norm: torch.Tensor | None = None
    max_found: torch.Tensor | None = None
    daly_k: torch.Tensor | None = None
    # K > 1: the last population's log model probabilities, and for the
    # next generation the masked perturbation matrix and log model factor
    log_model_probs: torch.Tensor | None = None   # (K,)
    matrix: torch.Tensor | None = None            # (K, K)
    log_model_factor: torch.Tensor | None = None  # (K,)
    # LocalTransition: generations since the last refit (the cadence)
    gens_since: torch.Tensor | None = None        # () int32
    # an adaptive population size: this generation's n (K16 sets the next)
    n_target: torch.Tensor | None = None          # () int32


@dataclass
class GenerationRun:
    """One generation's rounds: host counters and the device buffers."""

    n_acc: int
    rounds: int
    n_valid: int
    eps_at_min: bool
    counters: torch.Tensor
    res: dict
    rec: dict | None
    #: the generation's target n, as the host read it with the counters
    n_target: int
    #: segmented early reject: K18's int64 counters of the generation
    seg: torch.Tensor | None = None
    #: segmented early reject under an adaptive distance: K22's (6, S)
    #: moment block of the generation's resolved slots
    mom: torch.Tensor | None = None


class DeviceContext:
    N_REDRAWS = N_REDRAWS

    def __init__(self, *, model, prior, distance, acceptor, transition,
                 spec, x0: torch.Tensor, device: torch.device,
                 generator: torch.Generator, B: int, n_cap: int,
                 rec_cap: int, max_rounds: int,
                 sync_ledger: SyncLedger | None = None, seed: int = 0,
                 temp_config=None, models=None, priors=None,
                 model_prior=None, mpk=None, fit_statics=None,
                 local_statics=None):
        self.model = model
        self.prior = prior
        #: K > 1 (model selection): the models; ``_init_models`` takes their
        #: priors, the model prior, the perturbation matrix and fit statics
        self.models = list(models) if models is not None else [model]
        self.K = len(self.models)
        self.distance = distance
        self.acceptor = acceptor
        self.transition = transition
        self.spec = spec
        self.x0 = x0
        self.device = device
        #: draws of user simulators (built-in models draw from Philox)
        self.generator = generator
        self.seed = int(seed)
        if self.K > 1:
            self._init_models(priors, model_prior, mpk, fit_statics)
        else:
            self.prior_arrays = prior.arrays(device)
            self.d = prior.dim
        #: round counters of the generation in progress (generation_while)
        self.counters = torch.zeros(5, dtype=torch.int32, device=device)
        self.B, self.n_cap, self.rec_cap = int(B), int(n_cap), int(rec_cap)
        self.max_rounds = int(max_rounds)
        self.S = spec.total_size
        self.sync_ledger = sync_ledger or SyncLedger()
        self.use_hist = bool(getattr(acceptor, "use_complete_history",
                                     False))
        #: noisy ABC: K21b's descriptor (``epsilon.temperature.TempConfig``)
        #: and its scheme tables on the device, built once
        self.temp_config = temp_config
        self.stochastic = temp_config is not None
        if self.stochastic:
            self.temp_tables = scheme_tables(temp_config.schemes, device)
            self.init_tables = scheme_tables((temp_config.initial,), device)
        #: segmented early reject: ``segment_cfg()``, set by the driver
        self.seg_cfg: dict | None = None
        #: K18's counters of the generation in progress
        self.seg_counters: torch.Tensor | None = None
        #: K22's moment block of the generation in progress (adaptive)
        self.seg_moments: torch.Tensor | None = None
        #: the generation's rounds as the host last read them
        self.rounds_read = 0
        #: K18's transformed-bound operands of the generation in progress
        self.lin_bp: dict | None = None
        #: a transforming statistic's entries (accept, transform), by its
        #: kind (``LEARNED_KERNELS``; set by ``boundary_transform``, or
        #: before the calibration for an ``IdentitySumstat``'s functions)
        self.learned: tuple | None = None
        #: the host-refit mode: the fetch ships raw rows, the transform's
        #: parameters change only at a boundary's host fit
        self.host_refit = False
        #: LocalTransition (every model's the same configuration): K2's
        #: local mode draws, K14 scores, K15 then K12 and K13 refit with each
        #: model's K12 arguments (``local_configs``, from the models'
        #: ``fit_statics`` and k tables: ``local_statics``)
        self.local = isinstance(transition, LocalTransition)
        self.local_statics = local_statics
        self.local_configs = None
        if self.local:
            dims = self.dims if self.K > 1 else [self.d]
            self.local_configs = [
                LocalTransition.field_config(self.n_cap, dim, device=device,
                                             **st)
                for dim, st in zip(dims, local_statics)]

    def _init_models(self, priors, model_prior, mpk, fit_statics) -> None:
        """The K > 1 device constants, built once per run."""
        dev, f32 = self.device, torch.float32
        self.priors = list(priors)
        self.dims = [p.dim for p in self.priors]
        self.d = max(self.dims)
        self.prior_arrays = stacked_arrays(self.priors, dev)
        self.dims_f = torch.tensor([float(x) for x in self.dims], dtype=f32,
                                   device=dev)
        p = torch.tensor(model_prior, dtype=torch.float64)
        self.model_prior = p.to(f32).to(dev)
        self.model_logits = torch.log(p).to(f32).to(dev)
        self.mpk = torch.as_tensor(mpk, dtype=f32).contiguous().to(dev)
        self.fit_statics = list(fit_statics)

    # ------------------------------------------------------------ buffers
    def new_reservoir(self) -> dict:
        dev, f32 = self.device, torch.float32
        return {
            "theta": torch.zeros(self.n_cap, self.d, dtype=f32, device=dev),
            "sumstats": torch.zeros(self.n_cap, self.S, dtype=f32,
                                    device=dev),
            "distance": torch.zeros(self.n_cap, dtype=f32, device=dev),
            "log_weight": torch.full((self.n_cap,), -math.inf, dtype=f32,
                                     device=dev),
            "slot": torch.full((self.n_cap,), -1, dtype=torch.int32,
                               device=dev),
            **({"m": torch.zeros(self.n_cap, dtype=torch.int32, device=dev)}
               if self.K > 1 else {}),
        }

    def new_ring(self) -> dict | None:
        """The record ring; a noisy-ABC run's also keeps each record's
        theta and proposal log-density (``record_proposal``)."""
        if self.rec_cap <= 0:
            return None
        dev, f32 = self.device, torch.float32
        ring = {
            "sumstats": torch.zeros(self.rec_cap, self.S, dtype=f32,
                                    device=dev),
            "distance": torch.zeros(self.rec_cap, dtype=f32, device=dev),
            "accepted": torch.zeros(self.rec_cap, dtype=torch.bool,
                                    device=dev),
            "valid": torch.zeros(self.rec_cap, dtype=torch.bool,
                                 device=dev),
        }
        if self.stochastic:
            ring["theta"] = torch.zeros(self.rec_cap, self.d, dtype=f32,
                                        device=dev)
            ring["logq"] = torch.zeros(self.rec_cap, dtype=f32, device=dev)
        return ring

    # -------------------------------------------------------------- lanes
    def stream(self, t: int, tag: int) -> PhiloxStream:
        """The Philox stream ``tag`` of generation ``t`` for the rounds of
        the generation in progress."""
        return PhiloxStream(self.seed, t, tag, self.max_rounds,
                            self.counters)

    def _simulate(self, theta: torch.Tensor, t: int) -> torch.Tensor:
        return self.model.simulate_flat(
            theta, self.generator, self.spec,
            stream=self.stream(t, philox.SIM_NOISE))

    def _simulate_accept(self, theta, valid, eps, dist_w, hist_min,
                         pdf_norm, t, segmented: bool, lane_m=None,
                         **terms):
        """The round's simulator and K5 / K21a -> (sum stats, distance,
        accept, log weight); ``lane_m``: K > 1, the lanes' models.
        ``segmented``: K18 in the simulator's place, its ``keep`` the
        valid mask of the accept test, and under an adaptive distance
        K22's fold of the round's resolved slots while the round starts
        below ``rec_cap`` (the rounds the host read: no extra sync).
        Noisy ABC: K18's stochastic mode, with the temperature, the pdf
        norm and the ACCEPT stream K21a/K21c draws each row's uniform from.
        The fifth value is K18's ``keep`` (None on the classic path), the
        record ring's valid mask."""
        if not segmented:
            ss = (self._simulate(theta, t) if lane_m is None
                  else self._simulate_models(theta, lane_m, t))
            return (ss, *self._accept(ss, eps, dist_w, valid, hist_min,
                                      pdf_norm, t, **terms), None)
        cfg = self.seg_cfg
        fold = (self.seg_moments is not None
                and self.rounds_read * self.B < self.rec_cap)
        noisy = {}
        if self.stochastic:
            noisy = dict(noise=cfg["bound"], pdf_norm=pdf_norm,
                         accept=self.stream(t, philox.ACCEPT))
        if getattr(self.distance, "aggregated", False):
            # K18's aggregate mode: dist_w is K25's flat params
            noisy = dict(agg=self.distance.ps)
        w = dist_w
        if isinstance(dist_w, dict):
            # K18's transformed mode, its operands formed once a generation
            if self.lin_bp is None:
                self.lin_bp = cfg["prepare"](dist_w["w"], dist_w["ss"],
                                             cfg["index_map"])
            noisy, w = dict(lin=self.lin_bp), dist_w["w"]
        out = segment_round(
            cfg["seg"], theta, valid, self.stream(t, philox.SIM_NOISE),
            imap=cfg["index_map"], x0=self.x0, w=w,
            p=getattr(self.distance, "p", 2.0), eps=eps, hist_min=hist_min,
            width=self.S, seg_ctr=self.seg_counters, m=lane_m,
            dims=self.dims if self.K > 1 else None, return_nseg=fold,
            **noisy)
        ss, keep = out[0], out[1]
        if fold:
            moment_fold(self.seg_moments, ss, out[2], valid, cfg["seg_of"],
                        self.x0, self.counters, rec_cap=self.rec_cap)
        return (ss, *self._accept(ss, eps, dist_w, keep, hist_min, pdf_norm,
                                  t, **terms), keep)

    def _accept(self, ss, eps, dist_w, valid, hist_min, pdf_norm, t,
                logpri=None, logq=None, **model_terms):
        """K21a (noisy ABC), K25 (an aggregated distance; ``dist_w`` its
        flat params) or K5 -> (distance, accept, log weight); K > 1 passes
        K5 or K25 the lanes' models and the two model terms."""
        if self.stochastic:
            return kernel_accept(
                ss, self.x0, dist_w, eps, pdf_norm, valid,
                stream=self.stream(t, philox.ACCEPT),
                lin=self.temp_config.lin,
                apply_iw=self.acceptor.apply_importance_weighting,
                logpri=logpri, logq=logq, family=self.distance.family)
        if isinstance(dist_w, dict):
            # a fitted learned statistic: K23's transform and accept
            return self.learned[0](
                ss, self.x0, dist_w["ss"], dist_w["w"], eps, valid,
                p=self.distance.p, hist_min=hist_min, logpri=logpri,
                logq=logq)
        if self.distance.aggregated:
            return aggregate_accept_weight(
                ss, self.x0, dist_w, eps, valid, ps=self.distance.ps,
                hist_min=hist_min, logpri=logpri, logq=logq, **model_terms)
        return pnorm_accept_weight(
            ss, self.x0, dist_w, eps, valid, p=self.distance.p,
            hist_min=hist_min, logpri=logpri, logq=logq, **model_terms)

    def _simulate_models(self, theta, m, t: int) -> torch.Tensor:
        return simulate_models_flat(
            self.models, theta, m, self.generator, self.spec,
            stream=self.stream(t, philox.SIM_NOISE))

    def lanes_prior(self, eps: torch.Tensor, dist_w: torch.Tensor,
                    hist_min: torch.Tensor | None = None, *, t: int = 0,
                    tag: int = philox.PRIOR,
                    pdf_norm: torch.Tensor | None = None,
                    segmented: bool = False) -> dict:
        """One round proposed from the prior (generation 0, calibration);
        ``segmented`` runs K18 in the simulator's place."""
        if self.K > 1:
            # the model from the model prior, then its parameter prior;
            # the log weight is the acceptance weight alone (_lane_prior)
            theta, logpri, valid, m = propose.models(
                self.stream(t, tag), self.B, self.prior_arrays,
                self.model_prior)
            ss, d, accept, logw, keep = self._simulate_accept(
                theta, valid, eps, dist_w, hist_min, pdf_norm, t, segmented,
                lane_m=m)
            return {"theta": theta, "sumstats": ss, "distance": d,
                    "accepted": accept, "valid": valid, "log_weight": logw,
                    "logq": logpri, "m": m, "ring_valid": keep}
        theta, logpri, valid = propose(self.stream(t, tag), self.B,
                                       self.prior_arrays)
        ss, d, accept, logw, keep = self._simulate_accept(
            theta, valid, eps, dist_w, hist_min, pdf_norm, t, segmented)
        # the record's proposal density: the prior's (K = 1)
        return {"theta": theta, "sumstats": ss, "distance": d,
                "accepted": accept, "valid": valid, "log_weight": logw,
                "logq": logpri, "ring_valid": keep}

    def lanes_transition(self, params: dict, eps: torch.Tensor,
                         dist_w: torch.Tensor,
                         hist_min: torch.Tensor | None = None, *,
                         t: int, pdf_norm: torch.Tensor | None = None,
                         carry: Carry | None = None,
                         segmented: bool = False) -> dict:
        """One round proposed from the fitted transition (t > 0), with
        redraws against zero prior mass (K2). K > 1 takes the model terms
        from ``carry``; ``segmented`` runs K18 in the simulator's place."""
        if self.K > 1:
            stream = self.stream(t, philox.TRANSITION)
            draw = propose_local if self.local else propose
            theta, logpri, valid, m = draw.models(
                stream, self.B, self.prior_arrays, carry.log_model_probs,
                params, carry.matrix)
            logq = (local_logpdf if self.local
                    else mvn_mixture_logpdf).models(theta, m, params)
            ss, d, accept, logw, keep = self._simulate_accept(
                theta, valid, eps, dist_w, hist_min, pdf_norm, t, segmented,
                lane_m=m, logpri=logpri, logq=logq, m=m,
                model_logits=self.model_logits,
                log_model_factor=carry.log_model_factor)
            return {"theta": theta, "sumstats": ss, "distance": d,
                    "accepted": accept, "valid": valid, "log_weight": logw,
                    "logq": logq, "m": m, "ring_valid": keep}
        draw = propose_local if self.local else propose
        theta, logpri, valid = draw(self.stream(t, philox.TRANSITION),
                                    self.B, self.prior_arrays, params)
        logq = self.transition.device_logpdf(theta, params)
        # K = 1: log model prior = log model factor = 0
        ss, d, accept, logw, keep = self._simulate_accept(
            theta, valid, eps, dist_w, hist_min, pdf_norm, t, segmented,
            logpri=logpri, logq=logq)
        return {"theta": theta, "sumstats": ss, "distance": d,
                "accepted": accept, "valid": valid, "log_weight": logw,
                "logq": logq, "ring_valid": keep}

    # --------------------------------------------------------- generation
    def generation_while(self, lanes, n_target: int | torch.Tensor,
                         eps_at_min: torch.Tensor | None = None,
                         ring: bool = True) -> GenerationRun:
        """Propose rounds until ``n_target`` acceptances or the round
        budget; one counter read per round. ``n_target`` is a host int or
        a 0-dim device int32 (an adaptive n): either lands in the counters'
        ``N_TARGET`` slot, which the first round's read brings to the host.
        ``ring=False`` skips the record ring (the calibration sample
        reduces the reservoir)."""
        res = self.new_reservoir()
        rec = self.new_ring() if ring else None
        record = rec is not None and "theta" in rec
        counters = torch.zeros(5, dtype=torch.int32, device=self.device)
        self.counters = counters
        if eps_at_min is not None:
            counters[EPS_AT_MIN] = eps_at_min.to(torch.int32)
        counters[N_TARGET] = (n_target if isinstance(n_target, torch.Tensor)
                              else int(n_target))
        self.rounds_read = 0
        while True:
            out = lanes()
            compact_round(out["accepted"], out["valid"], out["theta"],
                          out["sumstats"], out["distance"],
                          out["log_weight"], res, rec, counters,
                          logq=out["logq"] if record else None,
                          m=out["m"] if self.K > 1 else None,
                          ring_valid=(out.get("ring_valid")
                                      if rec is not None else None))
            host = counters.cpu()
            self.sync_ledger.record("round_counters", host.nbytes)
            n_acc, r = int(host[N_ACC]), int(host[ROUNDS])
            n_tgt = int(host[N_TARGET])
            self.rounds_read = r
            if not (n_acc < n_tgt and r < self.max_rounds):
                break
        return GenerationRun(n_acc=n_acc, rounds=r,
                             n_valid=int(host[N_VALID]),
                             eps_at_min=bool(host[EPS_AT_MIN]),
                             counters=counters, res=res, rec=rec,
                             n_target=n_tgt)

    def _local_refit(self, carry: Carry, theta: torch.Tensor,
                     w_norm: torch.Tensor, k_mask: torch.Tensor,
                     fit_statics: dict, cadence: tuple | None,
                     m: torch.Tensor | None = None):
        """LocalTransition's refit (``util.py:1908-1997``): K15 measures
        the drift of the accepted population against the fitted one and
        decides the refit on the device; K12 and K13 read its flag and
        return at once when it is 0, so the params carry forward with no
        host branch. Refit every generation (``cadence`` None) is the full
        factorization; under the cadence K13 factorizes only the changed
        rows. Below ``dim + 1`` accepted rows the old params carry forward.
        Several models (``m`` the rows' models): K15's K > 1 mode decides
        per model, then each model's K12 and K13 under its own flag (the
        rows changed summed over the models). -> (params, K15's outputs +
        ``rows_changed``)."""
        tr = self.transition
        every, thr = cadence if cadence is not None else (1, math.inf)
        if self.K > 1:
            dec = proposal_drift.models(
                carry.trans_params["thetas"], carry.trans_params["weights"],
                theta, w_norm, k_mask, m, dims=self.dims,
                fitted=carry.fitted, gens_since=carry.gens_since,
                every=every, thr=thr,
                min_counts=[tr.device_refit_min_count(x)
                            for x in self.dims])
            params, rows = tr.device_fit_models(
                theta, dec["w_models"], carry.trans_params, dec["flag"],
                dims=self.dims, configs=self.local_configs,
                incremental=cadence is not None)
            return params, {**dec, "rows_changed": rows}
        dec = proposal_drift(
            carry.trans_params["thetas"], carry.trans_params["weights"],
            theta, w_norm, k_mask, dim=self.d, fitted=carry.fitted,
            gens_since=carry.gens_since, every=every, thr=thr,
            min_count=tr.device_refit_min_count(self.d))
        if cadence is None:
            params = tr.device_fit(theta, w_norm, dim=self.d,
                                   prev=carry.trans_params,
                                   flag=dec["flag"], **fit_statics)
            return params, dec
        params, rows = tr.device_fit_update(
            theta, w_norm, carry.trans_params, dim=self.d, flag=dec["flag"],
            **fit_statics)
        return params, {**dec, "rows_changed": rows}

    # ------------------------------------------- segmented early reject
    def segment_cfg(self) -> dict:
        """The segmented round's configuration: the models' protocols (one,
        or K of one layout), their emission map onto the flat rows and its
        inverse (each column's segment, for K22's fold), and whether an
        adaptive distance folds moments. Raises with the blocking reason
        when the run cannot take it (no uniform protocol, no prefix bound;
        ``ABCSMC._early_reject_incapable_reason`` gates first). Under a
        stochastic acceptor the bound must be an upper log-density bound,
        under a uniform one a lower distance bound (the JAX package's
        ``segment_cfg`` soundness gate, both directions); ``bound`` is the
        noise kernel's bound dict K18's stochastic mode reads."""
        reason = uniform_protocol_reason(self.models)
        if reason is not None:
            raise ValueError(f"segmented execution unavailable: {reason}")
        bound = self.distance.device_bound_fn(self.spec)
        if bound is None:
            raise ValueError(
                "segmented execution unavailable: "
                f"{type(self.distance).__name__} has no monotone prefix "
                "bound (device_bound_fn)")
        if bool(bound.get("upper", False)) != self.stochastic:
            direction = ("an upper log-density" if bound.get("upper")
                         else "a lower distance")
            need = ("a StochasticAcceptor" if bound.get("upper")
                    else "a UniformAcceptor")
            raise ValueError(
                "segmented execution unavailable: "
                f"{type(self.distance).__name__} provides {direction} "
                f"bound, which is only sound under {need}")
        segs = [m.segmented for m in self.models]
        imap = self.model.index_map(self.spec, self.device)
        return {"seg": segs[0] if self.K == 1 else segs, "index_map": imap,
                "bound": bound if self.stochastic else None,
                "prepare": bound.get("prepare"),
                "seg_of": torch.as_tensor(seg_of_columns(imap),
                                          device=self.device),
                "moments": bool(getattr(self.distance, "adaptive", False))}

    def generation_while_seg(self, lanes, n_target: int,
                             eps_at_min: torch.Tensor | None = None
                             ) -> GenerationRun:
        """``generation_while`` with K18's counters for the generation (and
        K22's moment block under an adaptive distance): ``lanes`` proposes
        its rounds segmented. One counter read per round, as the classic
        loop; K18 and K22 add none. Noisy ABC keeps the record ring (K21b
        reads it): K6 records each round's rows with valid = K18's keep,
        so the ring holds completed evaluations only, as the JAX engine's
        does (``util.py:1086-1107``)."""
        self.seg_counters = torch.zeros(4, dtype=torch.int64,
                                        device=self.device)
        self.seg_moments = (init_moments(self.S, self.device)
                            if self.seg_cfg["moments"] else None)
        self.lin_bp = None
        run = self.generation_while(lanes, n_target, eps_at_min,
                                    ring=self.stochastic)
        run.seg, run.mom = self.seg_counters, self.seg_moments
        return run

    def k_mask(self, counters: torch.Tensor) -> torch.Tensor:
        """The kept rows: the first min(n_acc, n_target), both read from
        the counters in device memory."""
        n_keep = torch.minimum(counters[N_ACC], counters[N_TARGET])
        return torch.arange(self.n_cap, device=self.device) < n_keep

    def calibrate(self, n_cal: int, dist_w0: torch.Tensor, *,
                  calib_w: bool, calib_eps: bool, alpha: float,
                  multiplier: float):
        """Prior round(s) at eps = +inf: initial adaptive weights and the
        from-sample epsilon (``multigen_kernel``'s in-kernel calibration).
        Returns (w0, eps0 or None, the GenerationRun)."""
        inf = torch.tensor(math.inf, dtype=torch.float32, device=self.device)
        run = self.generation_while(
            lambda: self.lanes_prior(inf, dist_w0, t=CALIBRATION_GENERATION,
                                     tag=philox.CALIBRATION),
            n_cal, ring=False)
        mask = self.k_mask(run.counters)
        ss = run.res["sumstats"]
        w0, d0 = dist_w0, run.res["distance"]  # K5's distances under w0
        if calib_w and isinstance(dist_w0, dict):
            # an IdentitySumstat's functions: the scale in their space
            w, d0 = self._feature_refit(ss, mask, ss, dist_w0["ss"])
            w0 = {"w": w, "ss": dist_w0["ss"]}
        elif calib_w:
            w0, d0 = self.distance.refit(ss, mask, self.x0, ss,
                                         params=dist_w0)
        eps0 = None
        if calib_eps:
            eps0 = weighted_quantile(
                torch.where(mask, d0, torch.full_like(d0, math.inf)),
                mask.to(torch.float32), alpha) * multiplier
        return w0, eps0, run

    def calibrate_stochastic(self, n_cal: int, var: torch.Tensor):
        """Noisy ABC's calibration: prior round(s) at T = +inf (every lane
        with a finite kernel value is accepted), then K21b over the sample's
        kernel values -> (T0, pdf_norm0, max_found0, the GenerationRun);
        the host ``StochasticAcceptor.initialize`` and
        ``Temperature.initialize`` at t = 0, on the device."""
        inf = torch.tensor(math.inf, dtype=torch.float32, device=self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        run = self.generation_while(
            lambda: self.lanes_prior(inf, var, t=CALIBRATION_GENERATION,
                                     tag=philox.CALIBRATION, pdf_norm=zero),
            n_cal, ring=False)
        temp0, pdf_norm0, max_found0 = temperature_update.initial(
            res_distance=run.res["distance"],
            k_mask=self.k_mask(run.counters),
            tables=self.init_tables, config=self.temp_config)
        return temp0, pdf_norm0, max_found0, run

    def bootstrap_n(self, trans_next: dict, fit_statics: dict, t: int,
                    adaptive_n: tuple,
                    model_probs: torch.Tensor | None = None) -> dict:
        """K16 on the just-refit params (``inference/util.py:2094-2150``):
        the next generation's n from the bootstrap-CV bisection, as a 0-dim
        int32 in device memory (``n_next``); K > 1 weights the models' CVs
        by the new model probabilities. Its ancestors sit on the BOOT
        stream of generation ``t``. LocalTransition takes K16's
        LocalTransition mode with each model's K12 arguments."""
        target_cv, min_n, max_n, n_boot = adaptive_n
        if self.K > 1:
            stacked = trans_next
            dims, statics = self.dims, self.fit_statics
        else:
            stacked = {k: trans_next[k][None] for k in ("thetas", "weights",
                                                         "cdf")}
            dims, statics = [self.d], [fit_statics]
        return required_nr(
            stacked["thetas"], stacked["weights"], stacked["cdf"], dims=dims,
            statics=statics, seed=self.seed, generation=t,
            max_rounds=self.max_rounds, target_cv=target_cv, min_n=min_n,
            max_n=max_n, n_bootstrap=n_boot, model_p=model_probs,
            local=self.local_configs)

    def _sumstat_step(self, dist_w: dict, run: GenerationRun, k_mask,
                      w_norm, *, adaptive: bool, plan: dict | None):
        """A fitted learned statistic's part of the generation step
        (``util.py:1777-1862, 2051-2066``) -> (the next ``{"w", "ss"}``,
        the distances the epsilon quantile reads, outputs for the fetch).
        ``plan`` (the boundary generation): K23's fit on the reservoir, its
        decision and finite guard on the device. Then, adaptive: the record
        ring transformed by the new parameters and K9's refit over it (x0
        and the reservoir transformed too); else after a fit the
        reservoir's distances recomputed under the new parameters (K23's
        values mode). The fetch's rows: the generation's transformed under
        the parameters it was accepted with (the host-refit mode ships the
        raw rows)."""
        res = run.res
        accept, transform = self.learned
        ss_used, w_used = dist_w["ss"], dist_w["w"]
        ss_next = ss_used
        out = ({} if self.host_refit
               else {"sumstats": transform(res["sumstats"], ss_used)})
        if plan is not None:
            w_fit = torch.where(k_mask, torch.exp(w_norm),
                                torch.zeros_like(w_norm))
            args = (res["sumstats"], res["theta"][:, :plan["out_dim"]]
                    .contiguous(), w_fit, run.counters, ss_used)
            if plan["kind"] == "mlp":
                ss_next, flags = mlp_fit(*args, lr=plan["lr"],
                                         n_steps=plan["n_steps"],
                                         need=plan["need"])
            else:
                ss_next, flags = ridge_fit(*args, alpha=plan["alpha"],
                                           need=plan["need"])
            out.update(ss_fit=ss_next, fit_flags=flags)
        if adaptive:
            w_next, d_new = self._feature_refit(
                run.rec["sumstats"], run.rec["valid"], res["sumstats"],
                ss_next)
        elif plan is not None:
            w_next = w_used
            d_new = accept.values(res["sumstats"], self.x0, ss_next, w_used,
                                  p=self.distance.p)
        else:
            w_next, d_new = w_used, res["distance"]
        return {"w": w_next, "ss": ss_next}, d_new, out

    def _feature_refit(self, samples, valid, rows, params: dict | None):
        """An adaptive distance's refit in the transform's feature space:
        K9 over ``samples`` under ``valid``, x0 and ``rows`` transformed by
        ``params`` (None: the raw statistics) -> (weights, the distances
        of ``rows``)."""
        if params is None:
            return self.distance.refit(samples, valid, self.x0, rows)
        transform = self.learned[1]
        return self.distance.refit(
            transform(samples, params), valid,
            transform(self.x0[None], params)[0], transform(rows, params))

    def boundary_transform(self, carry: Carry, out: dict,
                           params: dict | None, *, kind: str, ring: bool,
                           t_next: int, adaptive: bool, eps_quantile: bool,
                           eps_weighted: bool, alpha: float,
                           multiplier: float) -> None:
        """A boundary's adaptation after a host fit (``smc.py:1481-1533`` of
        the JAX package: the predictor's update, then an adaptive
        distance's weights in the new feature space, the population's
        distances recomputed in it, the epsilon update on them): the same
        on the device from the outputs ``out`` of the generation before
        generation ``t_next`` (its raw rows, kept-row mask and normalized
        log weights; ``keep_inputs``) and the transform's parameters
        ``params`` of ``kind`` (None: the raw statistics), whose entries
        serve the rounds from then on. An adaptive distance refits over the
        record ring (``ring``: after generation 0, as the JAX package's
        generation-0 update reads every record) or over the accepted rows
        alone (a later boundary, the JAX package's declared deviation,
        ``dispatch.py:890-893``). ``carry`` gets ``dist_w = {"w", "ss"}``
        (the raw weights without a transform) and the new epsilon; the
        health word's epsilon recursion restarts, as a chunk the JAX
        package rebuilds from the host does."""
        dev = self.device
        if params is not None:
            self.learned = LEARNED_KERNELS[kind]
        rows = out["sumstats"]
        if adaptive:
            samples, valid = ((out["rec"]["sumstats"], out["rec"]["valid"])
                              if ring else (rows, out["k_mask"]))
            w, d_new = self._feature_refit(samples, valid, rows, params)
        else:
            w = self.distance.device_params(t_next, dev)
            w = w if params is None else w["w"]
            accept = identity_accept if params is None else self.learned[0]
            d_new = accept.values(rows, self.x0, params, w,
                                  p=self.distance.p)
        carry.dist_w = w if params is None else {"w": w, "ss": params}
        if eps_quantile:
            carry.eps = quantile_epsilon(d_new, out["k_mask"], out["w_norm"],
                                         eps_weighted, alpha, multiplier)
        carry.eps_prev = torch.full((), math.inf, dtype=torch.float32,
                                    device=dev)
        carry.stall_count = torch.zeros((), dtype=torch.int32, device=dev)

    def generation_step(self, carry: Carry, run: GenerationRun, *,
                        adaptive: bool, eps_quantile: bool,
                        eps_weighted: bool, alpha: float, multiplier: float,
                        fit_statics: dict, health_config: tuple | None,
                        t: int = 0, refit_cadence: tuple | None = None,
                        adaptive_n: tuple | None = None, last: bool = False,
                        sumstat_fit: dict | None = None,
                        keep_inputs: bool = False):
        """Everything between two generations, on the device:
        normalize -> adaptive reweight + distance recompute (K9 over the
        ring, or K22's finish over the moment block) -> quantile
        epsilon -> MVN refit (LocalTransition: K15's drift and cadence,
        then K12 and K13 under its flag) -> [noisy ABC: K3 over the ring,
        K21b] -> [an adaptive population size: K16, skipped when ``last``
        (the run stops after this generation, so n stays)] -> health word.
        The kept rows come from the counters in device memory; the host's
        read of them (``run.n_target``) scales the health word's ESS floor.
        A fitted learned statistic (``carry.dist_w`` a dict) runs K23's fit
        first when ``sumstat_fit`` holds the plan (the chunk's last
        generation), then the refit or the recompute in the new feature
        space (``_sumstat_step``). ``keep_inputs`` adds the kept-row mask, the
        normalized log weights and the record ring to the outputs (a
        boundary's host fit and ``boundary_transform`` read them). Returns
        (carry, outputs)."""
        res, counters = run.res, run.counters
        k_mask = self.k_mask(counters)
        w_norm = normalize_log_weights(res["log_weight"], k_mask)
        eps_g = carry.eps
        learned = {}
        if isinstance(carry.dist_w, dict):
            dist_w_next, d_new, learned = self._sumstat_step(
                carry.dist_w, run, k_mask, w_norm, adaptive=adaptive,
                plan=sumstat_fit)
        elif adaptive and run.mom is not None:
            # early reject: the refit over every resolved candidate's
            # simulated columns (K22), not the completed-only ring
            dist_w_next, d_new = self.distance.refit_from_moments(
                run.mom, self.x0, res["sumstats"])
        elif adaptive:
            # K9, or K25's refit for an aggregated distance
            dist_w_next, d_new = self.distance.refit(
                run.rec["sumstats"], run.rec["valid"], self.x0,
                res["sumstats"], params=carry.dist_w)
        else:
            dist_w_next = carry.dist_w
            d_new = res["distance"]
        if eps_quantile:
            eps_next = quantile_epsilon(d_new, k_mask, w_norm, eps_weighted,
                                        alpha, multiplier)
        else:
            eps_next = eps_g
        models = {}
        if self.K > 1 and self.local:
            # K15's per-model decisions, each model's K12 and K13, then K26
            # with K15's fitted mask (the refit minimum of dim + 1 rows)
            trans_next, refit = self._local_refit(
                carry, res["theta"], w_norm, k_mask, fit_statics,
                refit_cadence, m=res["m"])
            fitted_next = refit["fitted"]
            step = model_step(res["m"], w_norm, k_mask, carry.fitted,
                              self.mpk, fitted_next=fitted_next)
            models = {k: step[k] for k in ("log_model_probs", "matrix",
                                           "log_model_factor")}
        elif self.K > 1:
            # K26, then the per-model refit (one K8 launch over the models)
            step = model_step(res["m"], w_norm, k_mask, carry.fitted,
                              self.mpk)
            trans_next = mvn_fit.models(
                res["theta"], w_norm, res["m"], dims=self.dims,
                statics=self.fit_statics, dims_tensor=self.dims_f)
            fitted_next = step["fitted"]
            models = {k: step[k] for k in ("log_model_probs", "matrix",
                                           "log_model_factor")}
        elif self.local:
            trans_next, refit = self._local_refit(
                carry, res["theta"], w_norm, k_mask, fit_statics,
                refit_cadence)
            fitted_next = refit["fitted"]
        else:
            trans_next = self.transition.device_fit(
                res["theta"], w_norm, dim=self.d, **fit_statics)
            fitted_next = k_mask.sum() > 0
        n_acc = counters[N_ACC]
        acc_rate = n_acc.to(torch.float32) / counters[N_VALID].clamp_min(
            1).to(torch.float32)
        hist_min_next = (torch.minimum(carry.hist_min, eps_g)
                         if self.use_hist else carry.hist_min)
        out = {"theta": res["theta"], "distance": res["distance"],
               "log_weight": res["log_weight"], "sumstats": res["sumstats"],
               "eps_used": eps_g, "eps_next": eps_next,
               "dist_w_next": dist_w_next, **learned}
        if keep_inputs:
            out.update(k_mask=k_mask, w_norm=w_norm, rec=run.rec)
        if self.K > 1:
            out.update(m=res["m"], model_probs=step["model_probs"])
        if run.seg is not None:
            out["seg"] = run.seg
        if self.local and refit_cadence is not None:
            # the refit decision, the drift and the rows K13 factorized
            # ride the chunk's packed fetch
            out.update(refit=refit["refit"], drift=refit["drift"],
                       rows_changed=refit["rows_changed"])
        n_next = carry.n_target
        if adaptive_n is not None:
            # K16's answer, the probes that did work and the CV at max_n
            # (the first probe's) ride the chunk's fetch; a skipped K16
            # reports 0 probes
            probes = torch.zeros((), dtype=torch.int32, device=self.device)
            cv_max = torch.zeros((), dtype=torch.float32, device=self.device)
            if not last:
                k16 = self.bootstrap_n(
                    trans_next, fit_statics, t, adaptive_n,
                    model_probs=step["model_probs"] if self.K > 1 else None)
                n_next, probes = k16["n_next"], k16["state"][STEP]
                cv_max = k16["cvs"][0]
            out.update(n_next=n_next, k16_probes=probes, k16_cv_max=cv_max)
        noisy = {}
        if self.stochastic:
            cfg = self.temp_config
            logq_new = (self.transition.device_logpdf(run.rec["theta"],
                                                      trans_next)
                        if cfg.needs_logq_new else None)
            eps_next, pdf_n, mf_n, dk_n = temperature_update.update(
                rec=run.rec, logq_new=logq_new, res_distance=res["distance"],
                k_mask=k_mask, w_norm=w_norm, pdf_norm=carry.pdf_norm,
                max_found=carry.max_found, daly_k=carry.daly_k, temp=eps_g,
                acc_rate=acc_rate, tables=self.temp_tables, t_next=t + 1,
                config=cfg)
            noisy = {"pdf_norm": pdf_n, "max_found": mf_n, "daly_k": dk_n}
            out.update(eps_next=eps_next, pdf_norm_next=pdf_n,
                       max_found_next=mf_n, daly_k_next=dk_n)
        eps_prev_n, stall_n = carry.eps_prev, carry.stall_count
        if health_config is not None:
            ess_floor, acc_floor, stall_w, stall_rtol = health_config
            word, ess, eps_prev_n, stall_n = generation_health(
                theta=res["theta"], k_mask=k_mask, w_norm=w_norm,
                d_new=d_new, n_acc=n_acc, n_target=run.n_target,
                acc_rate=acc_rate, trans_params=carry.trans_params,
                trans_next=trans_next, fitted=carry.fitted,
                fitted_next=fitted_next, eps_g=eps_g, eps_next=eps_next,
                eps_prev=carry.eps_prev, stall_count=carry.stall_count,
                ess_floor=ess_floor, acc_floor=acc_floor,
                stall_window=stall_w, stall_rtol=stall_rtol)
            out["health"], out["ess"] = word, ess
        nxt = Carry(trans_params=trans_next, fitted=fitted_next,
                    dist_w=dist_w_next, eps=eps_next,
                    hist_min=hist_min_next, eps_prev=eps_prev_n,
                    stall_count=stall_n, **noisy, **models,
                    gens_since=refit["gens_since"] if self.local else None,
                    n_target=n_next)
        return nxt, out
