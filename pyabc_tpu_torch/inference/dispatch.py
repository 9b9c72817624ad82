"""The pipelined per-generation host loop
(``pyabc_tpu/inference/dispatch.py::run_pipelined`` counterpart).

Generation t + 1 is dispatched as soon as the adaptation on generation t
is done, and generation t is handed to the History's writer after it, so
the sqlite writes overlap the next generation's rounds. Proposals always
use generation t's final weights, so the run is statistically the serial
loop's. Where the pending strategy updates cannot change a lane's
distance (a fixed p-norm and a uniform acceptor without the complete
history), an eps = +inf round of K26's round kernel for generation t + 1
runs right after the transitions' refit, and its acceptance is applied
once the threshold is known (delayed evaluation): its lanes count ahead of
every round of the generation, which then samples only the shortfall.
"""
from __future__ import annotations

import copy
import logging
import math
import time

import numpy as np

from ..acceptor.acceptor import UniformAcceptor
from ..core.random import speculative_key
from ..distance.pnorm import PNormDistance
from ..sampler import BatchedSampler

logger = logging.getLogger("pyabc_tpu_torch.ABCSMC")


def speculation_capable(abc) -> bool:
    """Whether a speculative round may run (``smc.py:3687``): a batched
    sampler (a finite record cap is refused at construction), a distance
    that does not reweight between generations (a plain p-norm without a
    weight schedule or a learned statistic) and a uniform acceptor without
    the complete history, whose test reads (distance, eps) alone."""
    if not isinstance(abc.sampler, BatchedSampler):
        return False
    d = abc.distance_function
    if not (type(d) is PNormDistance and d.sumstat is None
            and not any(k >= 0 for k in d.weights)):
        return False
    a = abc.acceptor
    return type(a) is UniformAcceptor and not a.use_complete_history


def speculative_accept(abc, t_next: int, fetched: dict):
    """The delayed acceptance of a speculative round once generation
    ``t_next``'s threshold is fixed (``smc.py:3723``) -> (accept mask, the
    extra log weight)."""
    valid = np.asarray(fetched["valid"], bool)
    d = np.asarray(fetched["distance"], np.float64)
    return valid & (d <= abc.eps(t_next)), np.zeros_like(d)


def dispatch_speculative_round(abc, t_next: int, n_estimate: int) -> dict:
    """One eps = +inf round of generation ``t_next`` off the just-refit
    transitions (``dispatch.py:992``), at its own generation word
    (``core.random.speculative_key``), left on the card until the
    generation is dispatched."""
    ctx = abc._host_ctx
    B = abc.sampler._pick_B(n_estimate)
    mode, dyn = ctx.build_dyn_args(
        t=t_next, eps_value=math.inf, model_probabilities=abc._model_probs,
        transitions=abc.transitions,
        model_perturbation_kernel=abc.model_perturbation_kernel)
    out = ctx.round(speculative_key(t_next), B, mode, dyn)
    return {"out": out, "B": B, "t": t_next,
            "accept": lambda t, fetched: speculative_accept(abc, t, fetched)}


def run_pipelined(abc, *, minimum_epsilon, max_nr_populations,
                  min_acceptance_rate, max_total_nr_simulations,
                  max_walltime) -> None:
    """The pipelined loop (``dispatch.py:1019``)."""
    stops = dict(minimum_epsilon=minimum_epsilon,
                 max_nr_populations=max_nr_populations,
                 min_acceptance_rate=min_acceptance_rate,
                 max_total_nr_simulations=max_total_nr_simulations,
                 max_walltime=max_walltime)
    t, sims_total = 0, 0
    distance_changed = False
    last_strategies_s = 0.0  # the first generation never speculates
    clk = time.perf_counter

    def dispatch(t_next, speculative=None):
        t_d0 = clk()
        eps = abc.eps(t_next)
        abc.acceptor.note_epsilon(t_next, eps, distance_changed)
        n_t = abc.population_strategy(t_next)
        max_eval = (n_t / min_acceptance_rate if min_acceptance_rate > 0
                    else np.inf)
        syncs0 = abc.sync_ledger.count
        spec = abc._generation_spec(t_next)
        spec_s = clk() - t_d0
        handle = abc.sampler.dispatch(n_t, spec, t_next, max_eval=max_eval,
                                      speculative=speculative)
        handle["syncs0"] = syncs0
        handle["dispatch_telemetry"] = {
            "spec_s": round(spec_s, 4),
            "enqueue_s": round(clk() - t_d0 - spec_s, 4)}
        if speculative is not None:
            handle["dispatch_telemetry"]["speculative_accepted"] = (
                len(handle["spec"]["slots"]) if handle.get("spec") else 0)
        return handle, eps, n_t

    handle, current_eps, n_t = dispatch(t)
    while True:
        t_gen0 = clk()
        sample = abc.sampler.collect(handle)
        sample_s = clk() - t_gen0
        if sample.n_accepted < n_t:
            logger.info("stopping: only %d/%d accepted within budget",
                        sample.n_accepted, n_t)
            break
        pop = abc._sample_to_population(sample)
        nr_evals = abc.sampler.nr_evaluations_
        rounds = abc.sampler.rounds_
        sims_total += nr_evals
        acceptance_rate = n_t / nr_evals
        # the History keeps the distances before the adaptation
        db_pop = copy.copy(pop)
        t_adapt0 = clk()
        spec_round = None
        # the proposal's part first: a speculative round of t + 1 can then
        # run on the card while the strategies update on the host
        abc._adapt_proposal(pop)
        surely_stopping = abc._check_stop(t, current_eps, acceptance_rate,
                                          sims_total, **stops)
        if (not surely_stopping and speculation_capable(abc)
                and last_strategies_s > abc.speculation_min_adapt_s):
            spec_round = dispatch_speculative_round(abc, t + 1, n_t)
        t_strat0 = clk()
        distance_changed = abc._adapt_strategies(t, sample, pop, current_eps,
                                                 acceptance_rate)
        last_strategies_s = clk() - t_strat0
        adapt_s = clk() - t_adapt0
        # again after the updates: their time counts against max_walltime
        stop = surely_stopping or abc._check_stop(
            t, current_eps, acceptance_rate, sims_total, **stops)
        syncs = abc.sync_ledger.count - handle["syncs0"]
        if not stop:
            # the next generation's rounds, then this one's hand-over
            next_handle, next_eps, next_n = dispatch(t + 1,
                                                     speculative=spec_round)
        telemetry = {"sample_s": round(sample_s, 4),
                     "adapt_s": round(adapt_s, 4),
                     "n_evaluations": int(nr_evals), "rounds": rounds,
                     "n_target": int(n_t),
                     "acceptance_rate": round(acceptance_rate, 6),
                     "distance_changed": bool(distance_changed),
                     "pipelined": True, "syncs": syncs,
                     **handle.get("dispatch_telemetry", {})}
        persist_s = abc._host_persist(t, current_eps, db_pop, nr_evals,
                                      telemetry)
        abc.history.update_telemetry(t, {"persist_s": round(persist_s, 4)})
        abc._log_generation(
            t, current_eps, n_t, nr_evals, acceptance_rate, syncs, sample_s,
            adapt_s, persist_s, speculative_accepted=telemetry.get(
                "speculative_accepted", 0))
        if stop:
            break
        handle, current_eps, n_t = next_handle, next_eps, next_n
        t += 1
