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

A GridSearchCV (one model or several, a constant or listed size) refits
with K17 in K8's place: the fold fits, the held-out scores of every
candidate scaling, the winner and the full fit scaled by it, on the
generation's fold ids (a constant n's built once, a list's from the
chunk's table); proposals and densities are the MVN path's (K2, K3), and
the winner rides the chunk's fetch.

The per-generation host loop's samplers run a generation at their own
sizes (``dispatch_generation``: B, the reservoir, the ring and the round
bound given per call) on arguments built from the host's fits
(``build_dyn_args``), or one round at a time with no compaction (K26's
round kernel, ``round`` and ``run_round``: K2, K3, the simulator, K5,
and one read of the round's outputs).

Sharded sampling (``ABCSMC(..., sharded=n)`` without a mesh, the JAX
package's virtual shards, ``util.py::_multigen_sharded``): the round's B
lanes and the reservoir split into n shards (the lane-key reduction, lane
i keeping its Philox stream). Each round K24a compacts every running
shard's lanes into its own reservoir block up to its quota
(``generation_while_sharded``), under an adaptive distance after K24d's
fold of the shard's moment block; the host reads the ``(n, 4)`` counter
table once a round and stops when every shard is finished. K24b then
writes the quotas, the kept-row mask over the shard-blocked layout and the
generation's totals, which the generation step reads in place of the
first-n mask; an adaptive distance refits from the combined moment blocks
and recomputes the distances from the stored feature rows (K24d's finish);
the MVN refit follows the chunk cadence the caller decides. The chunk's
fetch merges the rows into dense order (K24c). Under an adaptive
aggregated distance the columns are the n sub-distances: K25's accept
writes each lane's values beside its distance (its value-rows mode, the
lanes' ``vals``), K24d folds them against a zero observation, K24a stores
an accepted lane's as its feature row (its given-rows mode), and K25's
sharded finish refits W and recomputes the distances; a fixed or
scheduled aggregate runs as unsharded.

On a device mesh (``ABCSMC(..., mesh=..., sharded=n)``, one process a
device, ``parallel/mesh.py``) rank d of w runs the global shards ``[d v,
(d + 1) v)`` (v = n / w): its lanes of each round (the streams' lane base,
``block``), its reservoir blocks and its slice of the quotas, with no
collective inside the generation. Then one gather: K24e packs the rank's
counters, table, reservoir columns and moment blocks, Gloo gathers the w
buffers in rank order and K24e's unpack tiles them into the global
shard-blocked arrays, the virtual-shard run's bit for bit; every rank then
runs the replicated stage (K24b, the refits, K7, K8, K26, K11) on them as
the virtual run does.

Every draw of a round sits at a fixed place of the run's Philox stream:
key = the seed, counter = (lane, block, generation, tag * stride_rounds +
round), the round read on the device from the counters; the stride is the
run's MAX_ROUNDS, which a stop rule that lowers the round bound leaves
alone. Calibration runs as generation -1 (2^32 - 1), so its draws never
meet generation 0's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ..kernels import philox
from ..core.random import CALIBRATION_GENERATION, RoundKey
from ..core.random_variables import stacked_arrays
from ..kernels.aggregate import aggregate_accept_weight
from ..kernels.bootstrap_cv import STEP, required_nr
from ..kernels.compact import compact_round
from ..kernels.gp_sumstat import gp_accept
from ..kernels.gp_sumstat import transform_rows as gp_transform_rows
from ..kernels.grid_search import grid_search_cv
from ..kernels.kernel_accept import kernel_accept
from ..kernels.linear_sumstat import linear_accept, transform_rows
from ..kernels.local_logpdf import local_logpdf
from ..kernels.mlp_fit import mlp_fit
from ..kernels.mlp_sumstat import mlp_accept
from ..kernels.mlp_sumstat import transform_rows as mlp_transform_rows
from ..kernels.model_step import model_step
from ..kernels.moments import moment_fold, seg_of_columns
from ..kernels.shard import shard_mask
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
from ..observability.sync import SyncLedger, to_host
from ..ops.health import generation_health
from ..ops.scale_reduce import init_moments
from ..ops.segment import uniform_protocol_reason
from ..kernels.mesh_pack import mesh_pack, mesh_unpack
from ..ops.shard import rank_block, shard_quota_host
from ..ops.stats import normalize_log_weights, quantile_epsilon
from ..sumstat.base import expand_rows, identity_accept
from ..transition.local_transition import LocalTransition
from ..utils import pow2_bucket

#: counters vector layout: n_acc, rounds, n_valid, eps <= min_eps, and the
#: generation's target n (the host reads it with the round's counters)
N_ACC, ROUNDS, N_VALID, EPS_AT_MIN, N_TARGET = range(5)
#: the (accept, transform) entries of a transform kind: K23's linear and
#: MLP ones (the device-fit plans, and the host-refit mode's linear, Lasso
#: and MLP predictors), the GP kernel's, and an ``IdentitySumstat``'s
#: functions before K5
LEARNED_KERNELS = {"linear": (linear_accept, transform_rows),
                   "mlp": (mlp_accept, mlp_transform_rows),
                   "gp": (gp_accept, gp_transform_rows),
                   "identity": (identity_accept, expand_rows)}


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
    #: moment block of the generation's resolved slots; a sharded one's
    #: (n, 6, S) shard blocks (K24d)
    mom: torch.Tensor | None = None
    #: sharded: K24b's kept rows over the shard-blocked reservoir, and
    #: whether every shard met its quota (the host's reading of the table)
    k_mask: torch.Tensor | None = None
    gen_ok: bool | None = None
    #: a mesh run: the primary's clock stop, as the gather brought it
    clock_stop: bool = False


@dataclass
class RoundResult:
    """Host copy of one round of B lanes (``util.py::RoundResult``)."""

    ms: np.ndarray
    thetas: np.ndarray
    sumstats: np.ndarray
    distances: np.ndarray
    accepted: np.ndarray
    valid: np.ndarray
    log_weights: np.ndarray
    #: each lane's proposal log-density
    logqs: np.ndarray | None = None


#: the round kernel's modes and the outputs of a round
ROUND_MODES = ("prior", "transition", "calibration")
ROUND_KEYS = ("m", "theta", "sumstats", "distance", "accepted", "valid",
              "log_weight", "logq")
#: a round's K > 1 model terms (``build_dyn_args``)
MODEL_TERMS = ("log_model_probs", "matrix", "log_model_factor")
#: the stacked (K > 1) MVN params K2 and K3 read
STACKED_PARAMS = ("thetas", "weights", "chol", "prec", "center", "thetas_c",
                  "quad", "logdet", "cdf")


def host_tensor(x, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: for the card one pinned, non-blocking
    copy (the host does not wait), else the tensor itself."""
    x = torch.as_tensor(x)
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


class DeviceContext:
    N_REDRAWS = N_REDRAWS

    def __init__(self, *, model, prior, distance, acceptor, transition,
                 spec, x0: torch.Tensor, device: torch.device,
                 generator: torch.Generator, B: int, n_cap: int,
                 rec_cap: int, max_rounds: int,
                 sync_ledger: SyncLedger | None = None, seed: int = 0,
                 temp_config=None, models=None, priors=None,
                 model_prior=None, mpk=None, fit_statics=None,
                 local_statics=None, stride_rounds: int | None = None,
                 n_shards: int | None = None, mesh=None):
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
        #: K26's round kernel: every round's counters (``_round_counters``)
        #: and the calibration's zero lanes a B, each made once
        self._round_table = None
        self._zero_lanes: dict = {}
        self.B, self.n_cap, self.rec_cap = int(B), int(n_cap), int(rec_cap)
        #: sharded sampling: the number of shards (None: unsharded); the
        #: record-ring window ``rec_cap`` is then a shard's
        self.n_shards = int(n_shards) if n_shards else None
        if self.n_shards and (self.B % self.n_shards
                              or self.n_cap % self.n_shards):
            raise ValueError(f"{self.n_shards} shards must divide B "
                             f"{self.B} and n_cap {self.n_cap}")
        #: a device mesh run: this rank's ``parallel.mesh.MeshRank``; and
        #: the (first global lane, lanes) of the rank's block of the round
        #: in progress, which the lane kernels draw at (None: the round)
        self.mesh = mesh
        self.block: tuple[int, int] | None = None
        #: the loop's round bound (a stop rule may lower it) and the
        #: Philox counter's round stride (the run's MAX_ROUNDS, which no
        #: stop rule changes, so a rule moves no draw)
        self.max_rounds = int(max_rounds)
        self.stride_rounds = int(stride_rounds if stride_rounds is not None
                                 else max_rounds)
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
        #: a sharded adaptive aggregate's generation: K25's accept also
        #: writes the round's (B, n) sub-distances (``lane_values``)
        self.value_rows = False
        self.lane_values = None
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
    def new_reservoir(self, n_cap: int | None = None) -> dict:
        """The slot-ordered reservoir of ``n_cap`` rows (the context's by
        default; a host sampler's generation brings its own)."""
        dev, f32 = self.device, torch.float32
        n_cap = self.n_cap if n_cap is None else int(n_cap)
        return {
            "theta": torch.zeros(n_cap, self.d, dtype=f32, device=dev),
            "sumstats": torch.zeros(n_cap, self.S, dtype=f32, device=dev),
            "distance": torch.zeros(n_cap, dtype=f32, device=dev),
            "log_weight": torch.full((n_cap,), -math.inf, dtype=f32,
                                     device=dev),
            "slot": torch.full((n_cap,), -1, dtype=torch.int32, device=dev),
            **({"m": torch.zeros(n_cap, dtype=torch.int32, device=dev)}
               if self.K > 1 else {}),
        }

    def new_ring(self, rec_cap: int | None = None) -> dict | None:
        """The record ring; a noisy-ABC run's also keeps each record's
        theta and proposal log-density (``record_proposal``)."""
        rec_cap = self.rec_cap if rec_cap is None else int(rec_cap)
        if rec_cap <= 0:
            return None
        dev, f32 = self.device, torch.float32
        ring = {
            "sumstats": torch.zeros(rec_cap, self.S, dtype=f32, device=dev),
            "distance": torch.zeros(rec_cap, dtype=f32, device=dev),
            "accepted": torch.zeros(rec_cap, dtype=torch.bool, device=dev),
            "valid": torch.zeros(rec_cap, dtype=torch.bool, device=dev),
        }
        if self.stochastic:
            ring["theta"] = torch.zeros(rec_cap, self.d, dtype=f32,
                                        device=dev)
            ring["logq"] = torch.zeros(rec_cap, dtype=f32, device=dev)
        return ring

    # -------------------------------------------------------------- lanes
    def stream(self, t: int, tag: int) -> PhiloxStream:
        """The Philox stream ``tag`` of generation ``t`` for the rounds of
        the generation in progress."""
        return PhiloxStream(self.seed, t, tag, self.stride_rounds,
                            self.counters,
                            lane0=self.block[0] if self.block else 0)

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
        if self.distance.aggregated and self.value_rows:
            # K25's value-rows mode: the sub-distances it summed, for K24d's
            # fold and K24a's feature rows
            d, accept, logw, self.lane_values = (
                aggregate_accept_weight.value_rows(
                    ss, self.x0, dist_w, eps, valid, ps=self.distance.ps,
                    hist_min=hist_min, logpri=logpri, logq=logq,
                    **model_terms))
            return d, accept, logw
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
                    segmented: bool = False, B: int | None = None,
                    model_logq: bool = False) -> dict:
        """One round proposed from the prior (generation 0, calibration);
        ``segmented`` runs K18 in the simulator's place; ``B`` lanes (the
        context's by default); ``model_logq`` (K > 1): logq adds the
        lane's model's log prior (K2 forms it)."""
        B = self._lanes_of_round() if B is None else int(B)
        if self.K > 1:
            # the model from the model prior, then its parameter prior;
            # the log weight is the acceptance weight alone (_lane_prior)
            theta, logpri, valid, m = propose.models(
                self.stream(t, tag), B, self.prior_arrays, self.model_prior,
                model_logits=self.model_logits if model_logq else None)
            ss, d, accept, logw, keep = self._simulate_accept(
                theta, valid, eps, dist_w, hist_min, pdf_norm, t, segmented,
                lane_m=m)
            return {"theta": theta, "sumstats": ss, "distance": d,
                    "accepted": accept, "valid": valid, "log_weight": logw,
                    "logq": logpri, "m": m, "ring_valid": keep,
                    **self._values_of_round()}
        theta, logpri, valid = propose(self.stream(t, tag), B,
                                       self.prior_arrays)
        ss, d, accept, logw, keep = self._simulate_accept(
            theta, valid, eps, dist_w, hist_min, pdf_norm, t, segmented)
        # the record's proposal density: the prior's (K = 1)
        return {"theta": theta, "sumstats": ss, "distance": d,
                "accepted": accept, "valid": valid, "log_weight": logw,
                "logq": logpri, "ring_valid": keep,
                **self._values_of_round()}

    def lanes_transition(self, params: dict, eps: torch.Tensor,
                         dist_w: torch.Tensor,
                         hist_min: torch.Tensor | None = None, *,
                         t: int, pdf_norm: torch.Tensor | None = None,
                         carry: Carry | None = None,
                         segmented: bool = False,
                         B: int | None = None) -> dict:
        """One round proposed from the fitted transition (t > 0), with
        redraws against zero prior mass (K2). K > 1 takes the model terms
        from ``carry``; ``segmented`` runs K18 in the simulator's place;
        ``B`` lanes (the context's by default)."""
        B = self._lanes_of_round() if B is None else int(B)
        if self.K > 1:
            stream = self.stream(t, philox.TRANSITION)
            draw = propose_local if self.local else propose
            theta, logpri, valid, m = draw.models(
                stream, B, self.prior_arrays, carry.log_model_probs,
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
                    "logq": logq, "m": m, "ring_valid": keep,
                    **self._values_of_round()}
        draw = propose_local if self.local else propose
        theta, logpri, valid = draw(self.stream(t, philox.TRANSITION),
                                    B, self.prior_arrays, params)
        logq = self.transition.device_logpdf(theta, params)
        # K = 1: log model prior = log model factor = 0
        ss, d, accept, logw, keep = self._simulate_accept(
            theta, valid, eps, dist_w, hist_min, pdf_norm, t, segmented,
            logpri=logpri, logq=logq)
        return {"theta": theta, "sumstats": ss, "distance": d,
                "accepted": accept, "valid": valid, "log_weight": logw,
                "logq": logq, "ring_valid": keep,
                **self._values_of_round()}

    def _lanes_of_round(self) -> int:
        """The lanes a round runs: a mesh rank's block, else B."""
        return self.block[1] if self.block else self.B

    def _values_of_round(self) -> dict:
        """``{"vals": the round's (B, n) sub-distances}`` in a sharded
        adaptive aggregate's generation (K25's value-rows mode), else
        nothing."""
        if not self.value_rows:
            return {}
        vals, self.lane_values = self.lane_values, None
        return {"vals": vals}

    # --------------------------------------------------------- generation
    def generation_while(self, lanes, n_target: int | torch.Tensor,
                         eps_at_min: torch.Tensor | None = None,
                         ring: bool = True, *, n_cap: int | None = None,
                         rec_cap: int | None = None,
                         max_rounds: int | None = None) -> GenerationRun:
        """Propose rounds until ``n_target`` acceptances or the round
        budget; one counter read per round. ``n_target`` is a host int or
        a 0-dim device int32 (an adaptive n): either lands in the counters'
        ``N_TARGET`` slot, which the first round's read brings to the host.
        ``ring=False`` skips the record ring (the calibration sample
        reduces the reservoir). ``n_cap``, ``rec_cap`` and ``max_rounds``
        default to the context's (a host sampler's generation brings its
        own)."""
        res = self.new_reservoir(n_cap)
        rec = self.new_ring(rec_cap) if ring else None
        max_rounds = self.max_rounds if max_rounds is None else max_rounds
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
            if not (n_acc < n_tgt and r < max_rounds):
                break
        return GenerationRun(n_acc=n_acc, rounds=r,
                             n_valid=int(host[N_VALID]),
                             eps_at_min=bool(host[EPS_AT_MIN]),
                             counters=counters, res=res, rec=rec,
                             n_target=n_tgt)

    def generation_while_sharded(self, lanes, n_target: int,
                                 eps_at_min: torch.Tensor | None = None, *,
                                 adaptive: bool = False,
                                 clock=None,
                                 sumstats: bool = True) -> GenerationRun:
        """One sharded generation (the JAX package's vmapped per-shard
        ``_generation_while``, ``util.py:2404-2420``): rounds of the global
        B lanes until every shard has met its quota of ``n_target`` or
        used ``max_rounds`` rounds. Each round, under an adaptive distance
        K24d folds the running shards' rows into their ``(n, 6, S)``
        moment blocks, then K24a compacts them into their reservoir blocks
        (with the distance-feature rows); the host reads the generation's
        counters and the ``(n, 4)`` table in one copy, the round's only
        sync. K24b then forms the kept-row mask and the totals on the
        device. There is no record ring: the moment blocks replace it.
        Under an adaptive aggregated distance the fold's and the feature
        rows' columns are the lanes' sub-distances (``vals``, K25's
        value-rows mode), folded against a zero observation (the JAX
        package's ``x0_cols``, ``aggregate.py:323``).

        On a mesh the rank runs its block (``ops.shard.rank_block``: its v
        shards on their slice of the quotas, their lanes, their rows) the
        same way, then gathers once (``_mesh_gather``) and forms the mask
        over the global arrays. ``clock``: a mesh run's clock stop, asked
        on the primary just before the gather, whose answer rides it to
        every rank (``GenerationRun.clock_stop``). ``sumstats``: whether a
        mesh run's reservoir statistics ride the gather (the fetch stores
        them for this generation); without them the gathered reservoir's
        ``"sumstats"`` is None, as nothing else of the sharded path reads
        them."""
        n = self.n_shards
        dev = self.device
        mesh = self.mesh
        blk = rank_block(n_target, n, mesh.width if mesh else 1,
                         mesh.rank if mesh else 0, B=self.B,
                         n_cap=self.n_cap)
        v = blk.v
        res = self.new_reservoir(blk.rows)
        values = adaptive and self.distance.aggregated
        # the columns of the fold and of the feature rows: S statistics,
        # or an aggregate's n sub-distances
        F = self.distance._feature_dim() if values else self.S
        x0_cols = (torch.zeros(F, dtype=torch.float32, device=dev) if values
                   else self.x0)
        if adaptive:
            res["dfeat"] = torch.zeros(blk.rows, F, dtype=torch.float32,
                                       device=dev)
        buf = torch.zeros(5 + 4 * v, dtype=torch.int32, device=dev)
        counters, table = buf[:5], buf[5:].view(v, 4)
        self.counters = counters
        if eps_at_min is not None:
            counters[EPS_AT_MIN] = eps_at_min.to(torch.int32)
        # a rank's v shards on the target whose quotas are its slice
        counters[N_TARGET] = blk.target
        mom = (init_moments(F, dev).expand(v, -1, -1).contiguous()
               if adaptive else None)
        quota = blk.quota
        p = float(getattr(self.distance, "p", 2.0))
        self.rounds_read = 0
        self.value_rows = values
        self.block = (blk.lane0, blk.lanes) if mesh else None
        try:
            while True:
                out = lanes()
                cols = out["vals"] if values else out["sumstats"]
                if mom is not None:
                    moment_fold.shards(mom, cols, out["valid"], x0_cols,
                                       counters, table, n_shards=v,
                                       rec_cap=self.rec_cap,
                                       max_rounds=self.max_rounds)
                compact_round.shards(
                    out["accepted"], out["valid"], out["theta"],
                    out["sumstats"], out["distance"], out["log_weight"], res,
                    counters, table, n_shards=v, max_rounds=self.max_rounds,
                    m=out["m"] if self.K > 1 else None, x0=self.x0, p=p,
                    feat_rows=cols if values else None)
                host = buf.cpu()
                self.sync_ledger.record("round_counters", host.nbytes)
                tab = host[5:].view(v, 4).numpy()
                self.rounds_read = int(host[ROUNDS])
                if ((tab[:, 0] >= quota)
                        | (tab[:, 1] >= self.max_rounds)).all():
                    break
        finally:
            self.value_rows = False
            self.block = None
        eps_min = bool(host[EPS_AT_MIN])
        clock_stop = False
        if mesh is not None:
            stop = mesh.rank == 0 and clock is not None and bool(clock())
            buf, res, mom, tab, clock_stop = self._mesh_gather(
                buf, res, mom, n_target, eps_at_min, stop, sumstats)
            counters, table = buf[:5], buf[5:].view(n, 4)
        cap_loc = self.n_cap // n
        _quota, k_mask, summary = shard_mask(counters, table, n_shards=n,
                                             cap_loc=cap_loc)
        quota_all = shard_quota_host(n_target, n)
        return GenerationRun(
            n_acc=int(tab[:, 0].sum()), rounds=int(tab[:, 1].max()),
            n_valid=int(tab[:, 2].sum()),
            eps_at_min=eps_min, counters=summary[:5],
            res=res, rec=None, n_target=int(n_target), mom=mom,
            k_mask=k_mask, clock_stop=clock_stop,
            gen_ok=bool((tab[:, 0] >= np.minimum(quota_all, cap_loc)).all()))

    def _mesh_gather(self, buf, res: dict, mom, n_target: int, eps_at_min,
                     stop: bool, sumstats: bool):
        """The generation's one collective on a mesh: K24e packs the rank's
        counters, its clock stop, its ``(v, 4)`` table, its reservoir
        blocks' columns (their statistics only under ``sumstats``) and its
        moment blocks; the mesh gathers the w buffers in rank order;
        K24e's unpack tiles them into the global
        counters buffer (the virtual run's: its rounds the largest rank's),
        reservoir and ``(n, 6, F)`` moment blocks -> (buf, res, mom, the
        ``(n, 4)`` table on the host, the primary's stop)."""
        mesh, n, dev = self.mesh, self.n_shards, self.device
        flag = torch.full((1,), int(stop), dtype=torch.int32, device=dev)
        cols = [k for k in res if sumstats or k != "sumstats"]
        pieces = [buf[:5], flag, buf[5:], *(res[k] for k in cols)]
        if mom is not None:
            pieces.append(mom)
        lens = [p.numel() for p in pieces]
        host, recv = mesh.gather(mesh_pack(pieces), self.sync_ledger)
        v4 = buf.numel() - 5
        tab = host[:, 6:6 + v4].reshape(n, 4)
        rounds = host[:, ROUNDS]
        mesh.stats["rounds"].append(int(rounds[mesh.rank]))
        gbuf = torch.zeros(5 + 4 * n, dtype=torch.int32, device=dev)
        if eps_at_min is not None:
            gbuf[EPS_AT_MIN] = eps_at_min.to(torch.int32)
        gbuf[N_TARGET] = int(n_target)
        # the virtual loop's round count: its longest-running shard's
        gbuf[ROUNDS] = int(rounds.max())
        gres = {k: torch.empty((res[k].shape[0] * mesh.width,
                                *res[k].shape[1:]), dtype=res[k].dtype,
                               device=dev) for k in cols}
        gmom = (None if mom is None else torch.empty(
            (n, *mom.shape[1:]), dtype=mom.dtype, device=dev))
        dsts = [None, None, gbuf[5:], *(gres[k] for k in cols)]
        if mom is not None:
            dsts.append(gmom)
        mesh_unpack(recv, dsts, lens)
        if not sumstats:
            gres["sumstats"] = None
        return gbuf, gres, gmom, tab, bool(host[0, 5])

    # ------------------------------------------------ K26's round kernel
    def round(self, key: RoundKey, B: int, mode: str, dyn: dict) -> dict:
        """K26's round kernel (``util.py::DeviceContext.round_kernel``
        ``:453``): proposes, simulates and tests one round of ``B`` lanes
        with no compaction -> the lanes' device tensors ``m`` (K > 1),
        ``theta``, ``sumstats``, ``distance``, ``accepted``, ``valid``,
        ``log_weight`` and ``logq``. A composite: its launches are the
        round's lane kernels, each counted by its own wrapper (K2 with K1
        inline, K3 in ``"transition"`` mode, the simulator, and K5 but in
        ``"calibration"`` mode: accepted = valid, distance and log weight
        0), with no other operation on the card. ``key`` is a
        ``RoundKey``: the round draws where ``generation_while``'s round of
        that index of that generation word draws."""
        if mode not in ROUND_MODES:
            raise ValueError(f"round mode {mode!r}: one of {ROUND_MODES}")
        self.counters = self._round_counters(int(key.round))
        return self._round_lanes(mode, dyn, int(key.generation), int(B))

    def _round_counters(self, r: int) -> torch.Tensor:
        """Round ``r``'s counters (only ``ROUNDS`` set): a row of a table of
        every round, brought to the device once in one copy, which the
        lane kernels only read."""
        if not 0 <= r < self.stride_rounds:
            raise ValueError(f"round {r} outside [0, {self.stride_rounds})")
        if self._round_table is None:
            table = np.zeros((self.stride_rounds, 5), np.int32)
            table[:, ROUNDS] = np.arange(self.stride_rounds)
            self._round_table = host_tensor(table, self.device)
        return self._round_table[r]

    def _round_lanes(self, mode: str, dyn: dict, gen: int, B: int) -> dict:
        """One round of ``mode`` at the generation word ``gen`` on the
        counters of ``self.counters`` (``build_dyn_args``'s ``dyn``); a
        K > 1 prior round's logq is the proposal's density, the model
        prior's logit added (``_lane_prior``)."""
        tag = (philox.CALIBRATION if gen == CALIBRATION_GENERATION
               else philox.PRIOR)
        if mode == "transition":
            # K > 1: the model terms lanes_transition reads off a carry
            terms = (SimpleNamespace(**{k: dyn[k] for k in MODEL_TERMS})
                     if self.K > 1 else None)
            out = self.lanes_transition(
                dyn["trans_params"], dyn["eps"], dyn["dist_w"],
                dyn["hist_min"], t=gen, carry=terms, B=B)
        elif mode == "prior":
            out = self.lanes_prior(dyn["eps"], dyn["dist_w"],
                                   dyn["hist_min"], t=gen, tag=tag, B=B,
                                   model_logq=True)
        else:
            out = self._lanes_calibration(gen, tag, B)
        return {k: out[k] for k in ROUND_KEYS if k in out}

    def _lanes_calibration(self, gen: int, tag: int, B: int) -> dict:
        """``_lane_calibration`` (``util.py:352-363``): a prior draw and the
        simulator, no accept test; accepted is the valid mask itself and
        the distance and log weight one zero vector a B, made once."""
        stream = self.stream(gen, tag)
        if self.K > 1:
            theta, logq, valid, m = propose.models(
                stream, B, self.prior_arrays, self.model_prior,
                model_logits=self.model_logits)
            ss = self._simulate_models(theta, m, gen)
        else:
            theta, logq, valid = propose(stream, B, self.prior_arrays)
            ss, m = self._simulate(theta, gen), None
        if B not in self._zero_lanes:
            self._zero_lanes[B] = host_tensor(np.zeros(B, np.float32),
                                              self.device)
        zero = self._zero_lanes[B]
        out = {"theta": theta, "sumstats": ss, "distance": zero,
               "accepted": valid, "valid": valid, "log_weight": zero,
               "logq": logq}
        if m is not None:
            out["m"] = m
        return out

    def run_round(self, key: RoundKey, B: int, mode: str,
                  dyn: dict) -> RoundResult:
        """One round and its one host read (``util.py::run_round``
        ``:3287``): the round's outputs reach the host in pinned buffers
        behind one wait, recorded as ``round_fetch``."""
        out = self.round(key, B, mode, dyn)
        host = to_host(out, self.sync_ledger, "round_fetch")
        return RoundResult(
            ms=(host["m"].astype(np.int32) if "m" in host
                else np.zeros(B, np.int32)),
            thetas=host["theta"].astype(np.float64),
            sumstats=host["sumstats"].astype(np.float64),
            distances=host["distance"].astype(np.float64),
            accepted=host["accepted"].astype(bool),
            valid=host["valid"].astype(bool),
            log_weights=host["log_weight"].astype(np.float64),
            logqs=host["logq"].astype(np.float64))

    def dispatch_generation(self, key: int, B: int, mode: str, dyn: dict, *,
                            n_cap: int, rec_cap: int, max_rounds: int,
                            n_target: int | None = None) -> dict:
        """One whole generation at a host sampler's sizes
        (``util.py::dispatch_generation`` ``:1266``): ``generation_while``
        over rounds of ``mode`` at the generation word ``key``, B lanes, an
        ``n_cap`` reservoir and an ``rec_cap`` record ring (none below 2),
        one counter read a round. Returns the round counters as the host
        read them (``n_acc``, ``rounds``, ``n_valid``) and the device
        tensors (the reservoir, the ring as ``rec_*``); under an adaptive
        distance also the ring's scale ``rec_scale`` (K9 on the card, the
        JAX kernel's ``device_record_reduce``), so the ring itself need not
        be read."""
        n_target = n_cap if n_target is None else min(int(n_target), n_cap)
        ring = rec_cap > 1
        if n_target <= 0:
            # a speculative round filled the generation: no round runs
            run = GenerationRun(
                n_acc=0, rounds=0, n_valid=0, eps_at_min=False, counters=None,
                res=self.new_reservoir(n_cap),
                rec=self.new_ring(rec_cap) if ring else None, n_target=0)
        else:
            run = self.generation_while(
                lambda: self._round_lanes(mode, dyn, int(key), int(B)),
                n_target, ring=ring, n_cap=n_cap,
                rec_cap=rec_cap if ring else 0, max_rounds=max_rounds)
        out = {"n_acc": run.n_acc, "rounds": run.rounds,
               "n_valid": run.n_valid, **run.res}
        if run.rec is not None:
            out.update({f"rec_{k}": v for k, v in run.rec.items()})
            if getattr(self.distance, "adaptive", False):
                out["rec_scale"] = self.distance.scale(
                    run.rec["sumstats"], run.rec["valid"], self.x0)
        return out

    def build_dyn_args(self, *, t: int, eps_value: float,
                       model_probabilities: dict | None = None,
                       transitions=None, model_perturbation_kernel=None,
                       hist_min: float | None = None) -> tuple[str, dict]:
        """(mode, the round's device arguments) of generation t
        (``util.py::build_dyn_args`` ``:3302-3345``): eps, the distance's
        weights of generation t and, under ``use_complete_history``, the
        acceptor's running minimum; from t > 0 the host-fitted transitions'
        params padded to the power-of-two bucket of the largest fit
        (``device_params``), and under K > 1 the perturbation matrix masked
        to the fitted models with renormalized rows, the log model factor
        and the log model probabilities (K2's and K5's model terms). Every
        tensor goes to the card in a pinned, non-blocking copy: no read."""
        dev = self.device
        dyn = {"eps": host_tensor(np.float32(eps_value), dev),
               "dist_w": host_tensor(self.distance.device_params(t), dev),
               "hist_min": (host_tensor(np.float32(hist_min), dev)
                            if self.use_hist else None)}
        if t == 0 or transitions is None:
            return "prior", dyn
        fitted = np.asarray([tr.X is not None for tr in transitions], bool)
        n_fit = pow2_bucket(max(len(tr.X) for tr in transitions
                                if tr.X is not None))
        if self.K == 1:
            params = transitions[0].device_params(n_fit, self.d)
            dyn["trans_params"] = {k: host_tensor(v, dev) if k != "dim"
                                   else v for k, v in params.items()}
            return "transition", dyn
        probs = np.zeros(self.K)
        for m, p in model_probabilities.items():
            probs[int(m)] = p
        matrix = np.asarray(model_perturbation_kernel.device_params(),
                            np.float64)
        # never-fitted models cannot propose: mask and renormalize the rows
        matrix = matrix * fitted[None, :]
        row_sums = matrix.sum(axis=1, keepdims=True)
        matrix = np.where(row_sums > 0, matrix / np.where(
            row_sums > 0, row_sums, 1.0), 0.0)
        with np.errstate(divide="ignore"):
            log_model_factor = np.log(probs @ matrix)
            log_model_probs = np.log(probs)
        ref = next(tr for tr in transitions if tr.X is not None)
        per_model = [tr.device_params(n_fit, self.d) if tr.X is not None
                     else {k: np.zeros_like(v) for k, v in ref.device_params(
                         n_fit, self.d).items() if k != "dim"}
                     for tr in transitions]
        stacked = {k: host_tensor(np.stack([pm[k] for pm in per_model]), dev)
                   for k in STACKED_PARAMS}
        stacked["dims"] = self.dims_f
        dyn.update(
            trans_params=stacked,
            log_model_probs=host_tensor(log_model_probs.astype(np.float32),
                                        dev),
            matrix=host_tensor(matrix.astype(np.float32), dev),
            log_model_factor=host_tensor(
                log_model_factor.astype(np.float32), dev))
        return "transition", dyn

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
            eps0 = quantile_epsilon(d0, mask, None, False, alpha, multiplier)
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
            max_rounds=self.stride_rounds, target_cv=target_cv, min_n=min_n,
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
                        keep_inputs: bool = False,
                        folds: tuple | None = None, refit: bool = True):
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
        boundary's host fit and ``boundary_transform`` read them).
        ``folds``: a GridSearchCV's ``(fold ids (n_cap,) int32, number of
        folds)`` of this generation; K17 then refits in K8's place (K > 1:
        its K > 1 mode after K26) and its winner rides the outputs
        (``cv_best``). ``refit=False`` (sharded sampling's cadence, decided
        by the caller) keeps the MVN params of the carry: no K8 launch.
        Returns (carry, outputs)."""
        res, counters = run.res, run.counters
        k_mask = run.k_mask if run.k_mask is not None else self.k_mask(
            counters)
        w_norm = normalize_log_weights(res["log_weight"], k_mask)
        eps_g = carry.eps
        learned = {}
        if isinstance(carry.dist_w, dict):
            dist_w_next, d_new, learned = self._sumstat_step(
                carry.dist_w, run, k_mask, w_norm, adaptive=adaptive,
                plan=sumstat_fit)
        elif adaptive and self.n_shards:
            # sharded: the shards' moment blocks combined in shard order,
            # the distances from the stored feature rows (K24d's finish, or
            # K25's sharded finish for an aggregated distance)
            dist_w_next, d_new = self.distance.refit_sharded(
                run.mom, self.x0, res["dfeat"], params=carry.dist_w)
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
            # K26, then the per-model refit (one K8 launch over the models;
            # a GridSearchCV's one K17 launch)
            step = model_step(res["m"], w_norm, k_mask, carry.fitted,
                              self.mpk)
            if folds is not None:
                trans_next, _scores, cv_best = grid_search_cv.models(
                    res["theta"], w_norm, res["m"], folds[0],
                    n_folds=folds[1], dims=self.dims,
                    scalings=self.fit_statics[0]["scalings"],
                    selectors=[st["bandwidth_selector"]
                               for st in self.fit_statics],
                    dims_tensor=self.dims_f)
            elif refit:
                trans_next = mvn_fit.models(
                    res["theta"], w_norm, res["m"], dims=self.dims,
                    statics=self.fit_statics, dims_tensor=self.dims_f)
            else:
                trans_next = carry.trans_params
            fitted_next = step["fitted"]
            models = {k: step[k] for k in ("log_model_probs", "matrix",
                                           "log_model_factor")}
        elif self.local:
            trans_next, refit = self._local_refit(
                carry, res["theta"], w_norm, k_mask, fit_statics,
                refit_cadence)
            fitted_next = refit["fitted"]
        elif folds is not None:
            trans_next, _scores, cv_best = grid_search_cv(
                res["theta"], w_norm, folds[0], n_folds=folds[1], dim=self.d,
                scalings=fit_statics["scalings"],
                bandwidth_selector=fit_statics["bandwidth_selector"])
            fitted_next = k_mask.sum() > 0
        else:
            trans_next = (self.transition.device_fit(
                res["theta"], w_norm, dim=self.d, **fit_statics) if refit
                else carry.trans_params)
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
        if folds is not None:
            out["cv_best"] = cv_best
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
