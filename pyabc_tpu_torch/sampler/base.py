"""Sampler base and the Sample containers (``pyabc_tpu/sampler/base.py``
counterpart, without the scalar host closure's records).

``Sample`` is struct-of-arrays: the accepted particles as dense arrays and,
for the adaptive components (``record_rejected``, set by
``configure_sampler``), every evaluated record. A fused generation leaves
its record ring on the card as ``DeviceRecords``: the adaptive distance
reduces it there (K9) and anything else reads it once.
"""
from __future__ import annotations

import numpy as np

from ..observability.sync import SyncLedger, to_host


def exp_normalize_log_weights(log_w) -> np.ndarray:
    """Stable exp of relative log weights (float64): -inf gives 0, an
    all-non-finite input degrades to uniform weights (an all-accepted
    calibration round)."""
    log_w = np.asarray(log_w, np.float64)
    finite = np.isfinite(log_w)
    if finite.any():
        return np.where(finite, np.exp(log_w - log_w[finite].max()), 0.0)
    return np.ones_like(log_w)


class DeviceRecords:
    """The all-evaluations record ring kept on the card. ``scale`` is its
    ``(S,)`` scale where the generation reduced it on the card (an adaptive
    distance's K9); :meth:`to_host` reads the masked rows once, recorded in
    the run's ledger as ``records_fetch``."""

    def __init__(self, sumstats_dev, valid_dev, scale=None,
                 sync_ledger: SyncLedger | None = None):
        self.sumstats_dev = sumstats_dev
        self.valid_dev = valid_dev
        self.scale = scale
        self.sync_ledger = (sync_ledger if sync_ledger is not None
                            else SyncLedger())
        self._host: np.ndarray | None = None

    def to_host(self) -> np.ndarray:
        """Fetch and mask: the ``(n_valid, S)`` float64 matrix."""
        if self._host is None:
            host = to_host({"ss": self.sumstats_dev, "valid": self.valid_dev},
                           self.sync_ledger, "records_fetch")
            self._host = host["ss"].astype(np.float64)[
                host["valid"].astype(bool)]
        return self._host

    def __array__(self, dtype=None, copy=None):
        host = self.to_host()
        return host.astype(dtype) if dtype is not None else host

    @property
    def shape(self):
        return self.to_host().shape


class Sample:
    """One generation's harvest, struct-of-arrays. ``proposal_ids`` are
    global evaluation-slot indices in proposal order: sorting by them and
    trimming the overshoot beyond n keeps a batched sampler equivalent to
    sequential sampling."""

    def __init__(self, record_rejected: bool = False):
        self.record_rejected = record_rejected
        # the accepted particles
        self.ms: np.ndarray | None = None
        self.thetas: np.ndarray | None = None
        self.weights: np.ndarray | None = None
        self.distances: np.ndarray | None = None
        self.sumstats: np.ndarray | None = None
        self.proposal_ids: np.ndarray | None = None
        # every evaluated record (accepted and rejected)
        self.all_sumstats: np.ndarray | None = None
        self.all_distances: np.ndarray | None = None
        self.all_accepted: np.ndarray | None = None
        #: the record ring left on the card (a fused generation)
        self.device_records: DeviceRecords | None = None

    @property
    def n_accepted(self) -> int:
        return 0 if self.ms is None else len(self.ms)

    def set_accepted(self, *, ms, thetas, weights, distances, sumstats,
                     proposal_ids) -> None:
        order = np.argsort(proposal_ids, kind="stable")
        self.ms = np.asarray(ms)[order]
        self.thetas = np.asarray(thetas)[order]
        self.weights = np.asarray(weights)[order]
        self.distances = np.asarray(distances)[order]
        self.sumstats = (np.asarray(sumstats)[order] if sumstats is not None
                         else None)
        self.proposal_ids = np.asarray(proposal_ids)[order]

    def trim(self, n: int) -> None:
        """Deterministic overshoot trim: the first n by evaluation slot."""
        if self.n_accepted <= n:
            return
        for name in ("ms", "thetas", "weights", "distances", "sumstats",
                     "proposal_ids"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, v[:n])

    def set_all_records(self, *, sumstats, distances, accepted) -> None:
        """Store every evaluation's record."""
        if not self.record_rejected:
            return
        self.all_sumstats = np.asarray(sumstats)
        self.all_distances = np.asarray(distances)
        self.all_accepted = np.asarray(accepted)


class SampleFactory:
    """The sampler-wide sample options; adaptive components set
    ``record_rejected`` in ``configure_sampler``."""

    def __init__(self, record_rejected: bool = False):
        self.record_rejected = record_rejected

    def __call__(self) -> Sample:
        return Sample(self.record_rejected)


class Sampler:
    """Abstract sampler. ``nr_evaluations_`` reports the valid simulations
    of the last call; ``sync_ledger`` is the run's (``ABCSMC`` binds it)."""

    def __init__(self):
        self.nr_evaluations_: int = 0
        self.sample_factory = SampleFactory()
        self.sync_ledger = SyncLedger()

    def sample_until_n_accepted(self, n: int, generation_spec, t: int, *,
                                max_eval: float = np.inf,
                                all_accepted: bool = False) -> Sample:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"
