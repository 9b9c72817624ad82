"""The batched device sampler of the per-generation host loop
(``pyabc_tpu/sampler/batched.py`` counterpart).

Each round evaluates B lanes on the card; the host refills until n
acceptances. Lanes carry global evaluation-slot ids and the accepted set is
sorted by slot and trimmed beyond n, which keeps batched sampling
equivalent to sequential sampling. ``fused=True`` (the default) runs a
whole generation as ``DeviceContext.dispatch_generation``: its rounds
compact on the card with one counter read a round, and ``collect`` reads
the reservoir once, leaving the record ring on the card. ``fused=False``
runs K26's round kernel once a round (``DeviceContext.run_round``, one
read a round), B doubling on repeated undershoot.
"""
from __future__ import annotations

import numpy as np

from ..core.random import round_key
from ..observability.sync import to_host
from ..utils import pow2_bucket
from .base import DeviceRecords, Sample, Sampler, exp_normalize_log_weights


class BatchedSampler(Sampler):
    """``min_batch``/``max_batch`` bound the lanes of a round,
    ``overshoot`` is the safety factor of the predictive sizing;
    ``check_max_eval`` stops a generation at ``max_eval`` lanes and
    ``max_rounds`` at that many rounds."""

    def __init__(self, min_batch: int = 256, max_batch: int = 1 << 17,
                 overshoot: float = 1.3, check_max_eval: bool = False,
                 fused: bool = True, max_rounds: int = 256):
        super().__init__()
        self.min_batch = int(min_batch)
        self.max_batch = int(max_batch)
        self.overshoot = float(overshoot)
        self.check_max_eval = check_max_eval
        #: True: one device generation a call (one counter read a round and
        #: one collect); False: the per-round host loop of K26's round kernel
        self.fused = fused
        self.max_rounds = int(max_rounds)
        #: the acceptance rate carried across generations: sizes the first
        #: round of the next generation
        self._rate_estimate: float | None = None
        self._last_B: int | None = None
        #: the rounds of the last generation
        self.rounds_ = 0

    #: a fused generation can be dispatched and collected apart, the hook
    #: of the pipelined loop
    supports_pipelining = True

    def _pick_B(self, n: int) -> int:
        """A power-of-two B with wide hysteresis: the previous B stays
        unless the target moved by more than 8x."""
        rate = self._rate_estimate if self._rate_estimate else 0.5
        target = pow2_bucket(max(int(n / rate * self.overshoot),
                                 self.min_batch),
                             self.min_batch, self.max_batch)
        if (self._last_B is not None
                and self._last_B // 8 <= target <= self._last_B * 8):
            return self._last_B
        self._last_B = target
        return target

    def sample_until_n_accepted(self, n, generation_spec, t, *,
                                max_eval=np.inf, all_accepted=False
                                ) -> Sample:
        ctx = generation_spec.device
        mode, dyn = generation_spec.mode, generation_spec.dyn
        gen_key = generation_spec.gen_key
        if self.fused:
            return self.collect(self.dispatch(n, generation_spec, t,
                                              max_eval=max_eval))
        sample = self.sample_factory()
        chunks = []
        lanes_total = 0  # every lane (the slot-id base)
        nr_eval = 0      # valid lanes only: the model evaluations
        n_acc = 0
        r = 0
        B = self._pick_B(n)
        while n_acc < n:
            # guard on lanes_total: an all-invalid regime never advances
            # nr_eval; max_rounds is the unconditional backstop
            if self.check_max_eval and lanes_total >= max_eval:
                break
            if r >= self.max_rounds:
                break
            res = ctx.run_round(round_key(gen_key, r), B, mode, dyn)
            if all_accepted:
                res.accepted = res.valid.copy()
                res.log_weights = np.where(res.valid, 0.0, -np.inf)
            res.slot_ids = lanes_total + np.arange(B)
            chunks.append(res)
            lanes_total += B
            nr_eval += int(res.valid.sum())
            n_acc += int(res.accepted.sum())
            r += 1
            # B grows only on repeated undershoot
            rate = max(n_acc / lanes_total, 1.0 / lanes_total)
            if (n - n_acc) > rate * B:
                B = min(B * 2, self.max_batch)
        self.nr_evaluations_ = max(nr_eval, 1)
        self.rounds_ = r
        self._rate_estimate = max(n_acc / lanes_total, 1.0 / lanes_total)
        acc_mask = np.concatenate([c.accepted for c in chunks])
        return self._finalize_rounds(sample, chunks, acc_mask, n)

    def dispatch(self, n, generation_spec, t, *, max_eval=np.inf,
                 speculative=None) -> dict:
        """Run the generation's rounds on the card and return the handle
        ``collect`` reads. ``speculative``: an eps = +inf round already run
        for this generation (``inference.dispatch.
        dispatch_speculative_round``); its one read happens here, its
        delayed acceptance is applied now that the threshold is final, and
        the generation samples only the shortfall."""
        ctx = generation_spec.device
        mode, dyn = generation_spec.mode, generation_spec.dyn
        sample = self.sample_factory()
        spec_block = None
        n_target = n
        if speculative is not None:
            fetched = to_host(speculative["out"], self.sync_ledger,
                              "speculative_fetch")
            accept, extra_lw = speculative["accept"](speculative["t"],
                                                     fetched)
            B_spec = speculative["B"]
            idx = np.flatnonzero(accept)
            ms = (fetched["m"].astype(np.int32) if "m" in fetched
                  else np.zeros(B_spec, np.int32))
            spec_block = {
                "ms": ms[idx],
                "thetas": fetched["theta"].astype(np.float64)[idx],
                "sumstats": fetched["sumstats"].astype(np.float64)[idx],
                "distances": fetched["distance"].astype(np.float64)[idx],
                "log_weights": (fetched["log_weight"].astype(np.float64)[idx]
                                + np.asarray(extra_lw, np.float64)[idx]),
                # negative slots: the speculative round precedes every
                # round of the generation in the sort-by-slot trim
                "slots": idx - B_spec,
                "n_valid": int(fetched["valid"].astype(bool).sum()),
                "records": {
                    "distances": fetched["distance"].astype(np.float64),
                    "accepted": np.asarray(accept, bool),
                    "valid": fetched["valid"].astype(bool)},
            }
            n_target = max(n - len(idx), 0)
            # the speculative lanes spent evaluation budget
            max_eval = max(max_eval - B_spec, 1)
        B = self._pick_B(n)
        n_cap = pow2_bucket(n, 64)
        # an adaptive distance's record ring: 8 rows an accepted slot
        rec_cap = pow2_bucket(8 * n_cap, 256) if sample.record_rejected else 1
        max_rounds = self.max_rounds
        if self.check_max_eval and np.isfinite(max_eval):
            max_rounds = max(1, min(max_rounds, int(max_eval) // B))
        out = ctx.dispatch_generation(
            generation_spec.gen_key, B, mode, dyn, n_cap=n_cap,
            rec_cap=rec_cap, max_rounds=max_rounds, n_target=n_target)
        return {"out": out, "sample": sample, "n": n, "n_cap": n_cap,
                "spec": spec_block}

    def collect(self, handle) -> Sample:
        """Read the dispatched generation in one transfer (recorded as
        ``generation_collect``) and build the Sample. The record ring's
        statistics stay on the card (``DeviceRecords``)."""
        out = handle["out"]
        counts = {k: out[k] for k in ("n_acc", "rounds", "n_valid")}
        host = to_host({k: v for k, v in out.items()
                        if k not in counts and k != "rec_sumstats"},
                       self.sync_ledger, "generation_collect")
        host.update(counts)
        host["rec_sumstats_dev"] = out.get("rec_sumstats")
        host["rec_valid_dev"] = out.get("rec_valid")
        return self._finalize_fused(host, handle["sample"], handle["n"],
                                    handle["n_cap"], spec=handle.get("spec"))

    def _finalize_fused(self, out, sample, n, n_cap, spec=None) -> Sample:
        # only valid lanes count as evaluations: a proposal that failed
        # the prior-support redraws never reaches the model
        n_valid = int(out["n_valid"]) + (spec["n_valid"] if spec else 0)
        self.nr_evaluations_ = max(n_valid, 1)
        self.rounds_ = int(out["rounds"])
        k = min(int(out["n_acc"]), n_cap, n)
        ms = (np.asarray(out["m"][:k], np.int32) if "m" in out
              else np.zeros(k, np.int32))
        thetas = np.asarray(out["theta"][:k], np.float64)
        distances = np.asarray(out["distance"][:k], np.float64)
        sumstats = np.asarray(out["sumstats"][:k], np.float64)
        log_w = np.asarray(out["log_weight"][:k], np.float64)
        slots = np.asarray(out["slot"][:k])
        if spec is not None and len(spec["slots"]):
            # the speculative round's accepted lanes come first (negative
            # slots), merged at the raw log-weight level
            ms = np.concatenate([spec["ms"], ms])
            thetas = np.concatenate([spec["thetas"], thetas])
            distances = np.concatenate([spec["distances"], distances])
            sumstats = np.concatenate([spec["sumstats"], sumstats])
            log_w = np.concatenate([spec["log_weights"], log_w])
            slots = np.concatenate([spec["slots"], slots])
        sample.set_accepted(
            ms=ms, thetas=thetas, weights=exp_normalize_log_weights(log_w),
            distances=distances, sumstats=sumstats, proposal_ids=slots)
        sample.trim(n)
        if sample.record_rejected:
            valid = np.asarray(out["rec_valid"], bool)
            sample.all_distances = np.asarray(out["rec_distance"],
                                              np.float64)[valid]
            sample.all_accepted = np.asarray(out["rec_accepted"], bool)[valid]
            sample.device_records = DeviceRecords(
                out["rec_sumstats_dev"], out["rec_valid_dev"],
                scale=out.get("rec_scale"), sync_ledger=self.sync_ledger)
            if spec is not None:
                # the speculative lanes are evaluations too: their records
                # come first (their statistics stay out of the ring:
                # configurations that reduce the ring never speculate)
                r = spec["records"]
                rv = r["valid"]
                sample.all_distances = np.concatenate(
                    [r["distances"][rv], sample.all_distances])
                sample.all_accepted = np.concatenate(
                    [r["accepted"][rv], sample.all_accepted])
        n_acc_total = int(out["n_acc"]) + (len(spec["slots"])
                                           if spec is not None else 0)
        self._rate_estimate = max(n_acc_total / self.nr_evaluations_,
                                  1.0 / self.nr_evaluations_)
        return sample

    def _finalize_rounds(self, sample, chunks, acc_mask, n) -> Sample:
        cat = lambda name: np.concatenate(  # noqa: E731
            [getattr(c, name) for c in chunks])
        log_w = cat("log_weights")[acc_mask]
        sample.set_accepted(
            ms=cat("ms")[acc_mask], thetas=cat("thetas")[acc_mask],
            weights=exp_normalize_log_weights(log_w),
            distances=cat("distances")[acc_mask],
            sumstats=cat("sumstats")[acc_mask],
            proposal_ids=cat("slot_ids")[acc_mask])
        sample.trim(n)
        if sample.record_rejected:
            valid = cat("valid")
            sample.set_all_records(
                sumstats=cat("sumstats")[valid],
                distances=cat("distances")[valid],
                accepted=acc_mask[valid])
        return sample
