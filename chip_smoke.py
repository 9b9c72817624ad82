#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pyabc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more lines each:

1. the card (name and power limit from nvidia-smi), torch and CUDA
   versions, the compute capability (must be 9.0) and the kernel build;
2. every hand-written kernel (K3-K6) against its plain PyTorch version on
   the card, at the main-path shapes of BASELINE config 2 (B = 4096 lanes,
   n_cap = 1024, d = 4, S = 40), with its error, its device time ("ms":
   back-to-back calls replayed from one CUDA graph), its time per call
   ("call_ms": CUDA events around the same calls made from Python, the
   wrapper's host work included), the plain version's time per call (the
   plain compaction syncs on its boolean masks, so no plain version is
   graph-captured), the least time the card could take and, for K3, the
   time per call of the PyTorch logsumexp-over-matmul form of the same
   function;
3. the Gaussian conjugate toy (pop 1000, 6 generations, 32 seeds) on the
   card and on the CPU, the mean of its posterior means against the
   analytic posterior mean and the card's against the CPU's;
4. Lotka-Volterra config 2 (AdaptivePNormDistance(p=2), MedianEpsilon,
   pop 1000, observed_data(seed=0)), 10 generations: throughput, wall time
   and syncs per generation, the epsilon trail and the posterior means.
   The kernels' launch counts are reset just before this run and read just
   after it: each kernel of the path must have launched. A run of the same
   model under a fixed p-norm (6 generations) comes first; its epsilon
   trail must not increase.

Before the last line it prints one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Any failed check exits
nonzero without that line. Without a CUDA device it exits nonzero at once.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor)
#: FLOP/s, the rates the kernels' bounds are taken against
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

B_MAIN, N_CAP_MAIN, POP = 4096, 1024, 1000
#: seeds of the Gaussian toy, on the card and on the CPU
TOY_SEEDS = tuple(range(32))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 50, replays: int = 5) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's per-call cost (the wrapper's checks,
    allocation and launch) drops out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------ phase 2
def kernel_checks(dev) -> dict:
    """K3-K6 against their plain versions on main-path inputs."""
    import torch

    from pyabc_tpu_torch import AdaptivePNormDistance
    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.kernels import (compact_round, compact_round_plain,
                                         lv_simulate, lv_simulate_plain,
                                         mvn_mixture_logpdf,
                                         mvn_mixture_logpdf_plain,
                                         pnorm_accept_weight,
                                         pnorm_accept_weight_plain)
    from pyabc_tpu_torch.models import lotka_volterra as lv
    from pyabc_tpu_torch.ops.stats import weighted_quantile
    from pyabc_tpu_torch.transition import (MultivariateNormalTransition,
                                            silverman_rule_of_thumb)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, n, S = B_MAIN, N_CAP_MAIN, 40
    model, prior = lv.make_lv_model(), lv.default_prior()
    obs = lv.observed_data(seed=0)
    spec = SumStatSpec(obs)
    x0 = torch.as_tensor(spec.flatten_host(obs), dtype=torch.float32,
                         device=dev)
    results = {}

    # K4 on prior draws (includes lanes that grow past the 1e6 clip)
    theta = prior.rvs_array(B, gen, dev)
    noise = model.noise(B, gen, dev)
    kw = dict(n_obs=model.n_obs, n_substeps=model.n_substeps, dt=model.dt,
              y0=lv.Y0, noise_sd=model.noise_sd, log_parameters=False)
    ss_k = lv_simulate(theta, noise, **kw)
    ss_p = lv_simulate_plain(theta, noise, **kw)
    torch.cuda.synchronize()
    same_nan = bool((torch.isnan(ss_k) == torch.isnan(ss_p)).all())
    fin = torch.isfinite(ss_p)
    err = (ss_k - ss_p).abs()[fin]
    tol = 1e-3 + 1e-4 * ss_p.abs()[fin]
    k4_err = float(err.max())
    log(f"K4 lv_simulate: max_abs_err={k4_err:.3e} "
        f"max_rel_err={float((err / ss_p.abs()[fin].clamp_min(1)).max()):.3e}"
        f" nan_lanes={int(torch.isnan(ss_p).any(1).sum())}"
        f" same_nan={same_nan}")
    check(same_nan and bool((err <= tol).all()),
          "K4 outside |err| <= 1e-3 + 1e-4 |x| (FMA contraction over 190 "
          "RK4 steps)")
    steps = (model.n_obs - 1) * model.n_substeps
    k4_bytes = B * 4 * 4 + 2 * B * 2 * model.n_obs * 4
    k4_flops = B * (steps * 60 + model.n_obs * 2 * 3)
    results["lv_simulate"] = dict(
        err=k4_err,
        call_ms=time_ms(lambda: lv_simulate(theta, noise, **kw), 50),
        ms=graph_ms(lambda: lv_simulate(theta, noise, **kw)),
        plain_ms=time_ms(lambda: lv_simulate_plain(theta, noise, **kw), 3),
        bound=bound(k4_bytes, k4_flops), library_ms=None)

    # K3 on a transition fitted to the first n prior draws
    w = torch.rand(n, generator=gen, device=dev)
    w[n - 24:] = 0.0  # empty reservoir slots carry weight 0
    params = MultivariateNormalTransition.device_fit(
        theta[:n], w / w.sum(), dim=4, scaling=1.0,
        bandwidth_selector=silverman_rule_of_thumb)
    q = MultivariateNormalTransition.device_rvs(params, B, gen)
    lq_k = mvn_mixture_logpdf(q, params)
    lq_p = mvn_mixture_logpdf_plain(q, params)
    torch.cuda.synchronize()
    k3_err = float((lq_k - lq_p).abs().max())
    log(f"K3 mvn_mixture_logpdf: max_abs_err={k3_err:.3e} "
        f"range=[{float(lq_p.min()):.2f}, {float(lq_p.max()):.2f}]")
    check(k3_err <= 1e-3, "K3 outside |err| <= 1e-3 (f32 logsumexp of "
          "1000 terms in another order)")
    n_live = int((params["weights"] > 0).sum())
    k3_bytes = (B * 4 + 16 + 4 + n * 4 + 2 * n + 1 + B) * 4
    k3_flops = B * n_live * (2 * 4 + 8) + B * (2 * 16 + 8)

    def k3_library():
        u = q - params["center"]
        pu = u @ params["prec"].T
        maha = (u * pu).sum(1, keepdim=True) - 2.0 * (pu @ params[
            "thetas_c"].T) + params["quad"]
        lc = -0.5 * (4 * math.log(2 * math.pi) + params["logdet"] + maha)
        return torch.logsumexp(lc + torch.log(params["weights"]), dim=1)

    check(float((k3_library() - lq_p).abs().max()) <= 1e-3,
          "K3 library form disagrees")
    results["mvn_mixture_logpdf"] = dict(
        err=k3_err,
        call_ms=time_ms(lambda: mvn_mixture_logpdf(q, params), 50),
        ms=graph_ms(lambda: mvn_mixture_logpdf(q, params)),
        plain_ms=time_ms(lambda: mvn_mixture_logpdf_plain(q, params), 10),
        bound=bound(k3_bytes, k3_flops),
        library_ms=time_ms(k3_library, 10))

    # K5 on the K4 rows with MAD weights and a median epsilon
    dist = AdaptivePNormDistance(p=2)
    valid = torch.rand(B, generator=gen, device=dev) > 0.05
    wts = dist.weights_from_scale(dist.scale(ss_p, valid, x0))
    eps = weighted_quantile(
        torch.where(valid, dist.rows(ss_p, x0, wts),
                    torch.full((B,), math.inf, device=dev)),
        valid.float(), 0.5)
    logpri = prior.logpdf_array(q)
    k5_args = (ss_p, x0, wts, eps, valid)
    k5_kw = dict(p=2.0, logpri=logpri, logq=lq_p)
    d_k, a_k, lw_k = pnorm_accept_weight(*k5_args, **k5_kw)
    d_p, a_p, lw_p = pnorm_accept_weight_plain(*k5_args, **k5_kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(d_p)
    d_err = float(((d_k - d_p).abs() / d_p.abs().clamp_min(1.0))[fin].max())
    far = (d_p - eps).abs() > 1e-5 * eps.abs()
    flags_ok = bool((a_k == a_p)[far].all())
    lw_fin = torch.isfinite(lw_p)
    lw_err = float((lw_k - lw_p).abs()[lw_fin].max())
    k5_err = max(d_err, lw_err)
    log(f"K5 pnorm_accept_weight: max_rel_err(d)={d_err:.3e} "
        f"max_abs_err(logw)={lw_err:.3e} accept_flags_equal={flags_ok} "
        f"accepted={int(a_k.sum())}/{B}")
    check(d_err <= 1e-5 and lw_err <= 1e-5 and flags_ok
          and bool((torch.isfinite(lw_k) == lw_fin).all()),
          "K5 outside rel 1e-5 (sum order, sqrt vs pow) or flags differ")
    k5_bytes = (B * S + 2 * S + 1) * 4 + B + 2 * B * 4 + B * (4 + 1 + 4)
    results["pnorm_accept_weight"] = dict(
        err=k5_err,
        call_ms=time_ms(
            lambda: pnorm_accept_weight(*k5_args, **k5_kw), 100),
        ms=graph_ms(lambda: pnorm_accept_weight(*k5_args, **k5_kw)),
        plain_ms=time_ms(
            lambda: pnorm_accept_weight_plain(*k5_args, **k5_kw), 20),
        bound=bound(k5_bytes, B * S * 4), library_ms=None)

    # K6 on the K5 outputs, starting at n_acc = 0 (a main-path first round)
    rec_cap = 8 * n
    theta_c = q.contiguous()

    def buffers():
        res = {"theta": torch.zeros(n, 4, device=dev),
               "sumstats": torch.zeros(n, S, device=dev),
               "distance": torch.zeros(n, device=dev),
               "log_weight": torch.full((n,), -math.inf, device=dev),
               "slot": torch.full((n,), -1, dtype=torch.int32, device=dev)}
        rec = {"sumstats": torch.zeros(rec_cap, S, device=dev),
               "distance": torch.zeros(rec_cap, device=dev),
               "accepted": torch.zeros(rec_cap, dtype=torch.bool,
                                       device=dev),
               "valid": torch.zeros(rec_cap, dtype=torch.bool, device=dev)}
        return res, rec

    k6_in = (a_k, valid, theta_c, ss_p, d_k, lw_k)
    res_k, rec_k = buffers()
    res_p, rec_p = buffers()
    ctr_k = torch.zeros(4, dtype=torch.int32, device=dev)
    ctr_p = torch.zeros(4, dtype=torch.int32, device=dev)
    compact_round(*k6_in, res_k, rec_k, ctr_k)
    compact_round_plain(*k6_in, res_p, rec_p, ctr_p)
    torch.cuda.synchronize()
    same = bool(torch.equal(ctr_k, ctr_p))
    k6_err = 0.0
    for a, b in [*zip(res_k.values(), res_p.values()),
                 *zip(rec_k.values(), rec_p.values())]:
        same = same and bool(torch.equal(a.isnan(), b.isnan()))
        fin = ~torch.isnan(a.float())
        k6_err = max(k6_err, float((a.float()[fin] - b.float()[fin]).abs()
                                   .nan_to_num(0.0, 0.0, 0.0).max()))
        same = same and bool(torch.equal(a[fin], b[fin]))
    log(f"K6 compact_round: counters={ctr_k.tolist()} exact={same}")
    check(same, "K6 reservoir/ring/counters not bit-identical")
    # bytes the round must move, each once: the flags (accept only where
    # valid), sumstats and distance of every row the reservoir or the ring
    # keeps (in a first round every kept row is also a ring row), theta
    # and log weight of reservoir rows; then the rows written and the
    # counters read and written
    acc = a_k & valid
    rank = torch.cumsum(acc.int(), 0) - acc.int()
    to_res = acc & (rank < n)
    to_ring = valid & (torch.arange(B, device=dev) < rec_cap)
    n_res, n_ring = int(to_res.sum()), int(to_ring.sum())
    n_kept = int((to_res | to_ring).sum())
    k6_bytes = (B + int(valid.sum()) + n_kept * (S + 1) * 4
                + n_res * (4 + 1) * 4
                + n_res * (4 + S + 3) * 4 + n_ring * (S * 4 + 4 + 2)
                + 2 * 3 * 4)
    ctrs = [torch.zeros(4, dtype=torch.int32, device=dev) for _ in range(60)]
    ctr_g = torch.zeros(4, dtype=torch.int32, device=dev)
    it = iter(ctrs)
    results["compact_round"] = dict(
        err=k6_err,
        call_ms=time_ms(
            lambda: compact_round(*k6_in, res_k, rec_k, next(it)), 50,
            warmup=5),
        # the counters are zeroed before each replayed launch (one small
        # memset in the graph) so every launch does a first round's work
        ms=graph_ms(lambda: (ctr_g.zero_(), compact_round(
            *k6_in, res_k, rec_k, ctr_g))),
        plain_ms=time_ms(lambda: compact_round_plain(
            *k6_in, res_p, rec_p, torch.zeros(4, dtype=torch.int32,
                                              device=dev)), 10),
        bound=bound(k6_bytes, 0.0), library_ms=None)
    return results


# ------------------------------------------------------------ phases 3-4
def gaussian_toy(dev) -> None:
    """The conjugate toy over TOY_SEEDS seeds on the card and, as the
    reference, on the CPU (plain versions, another random stream)."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian

    mu_true, sd_true = gaussian.conjugate_posterior(1.0, noise_sd=0.5)
    means = {}
    for where in (dev, "cpu"):
        mus, ess_min = [], []
        t0 = time.perf_counter()
        for seed in TOY_SEEDS:
            abc = pt.ABCSMC(gaussian.make_mean_only_model(noise_sd=0.5),
                            gaussian.mean_only_prior(), pt.PNormDistance(p=2),
                            population_size=POP, eps=pt.MedianEpsilon(),
                            seed=seed, device=where)
            abc.new("sqlite://", {"x": 1.0})
            h = abc.run(max_nr_populations=6)
            check(h.n_populations == 6,
                  f"gaussian toy seed {seed} did not run 6 generations")
            ess = []
            for t in range(h.n_populations):
                _df, w_t = h.get_distribution(t=t)
                ess.append(float(1.0 / np.sum(w_t * w_t)))
            df, w = h.get_distribution()
            mus.append(float(np.sum(df["theta"] * w)))
            ess_min.append(min(ess))
            if seed == TOY_SEEDS[0]:
                sd = float(np.sqrt(np.sum(w * (df["theta"] - mus[0]) ** 2)))
                eps = [round(float(e), 5)
                       for e in h.get_all_populations()["epsilon"][1:]]
                log(f"gaussian toy ({where}, seed {seed}): pop={POP} gens=6 "
                    f"posterior mean={mus[0]:.4f} sd={sd:.4f} analytic "
                    f"mean={mu_true:.4f} sd={sd_true:.4f} eps={eps}")
                if where == dev:
                    check(abs(mus[0] - mu_true) < 0.1,
                          "gaussian posterior mean off by >= 0.1")
        wall = time.perf_counter() - t0
        m = float(np.mean(mus))
        se = float(np.std(mus, ddof=1) / math.sqrt(len(mus)))
        means[where] = (m, se)
        log(f"gaussian toy ({where}, {len(mus)} seeds, {wall:.2f} s): mean "
            f"of posterior means {m:.4f} se {se:.4f} (analytic {mu_true:.4f},"
            f" {(m - mu_true) / se:+.2f} se); per seed min {min(mus):.4f} "
            f"max {max(mus):.4f}; least ESS over the generations, lowest "
            f"seed {min(ess_min):.1f} median seed "
            f"{float(np.median(ess_min)):.1f}")
    (m_d, se_d), (m_c, se_c) = means[dev], means["cpu"]
    gap_se = (m_d - m_c) / math.hypot(se_d, se_c)
    log(f"gaussian toy: card - cpu {m_d - m_c:+.4f} ({gap_se:+.2f} se)")
    # the seed mean's standard error is about 0.008 (sd ~0.045 over 32
    # seeds), so a bias of 0.03 in the device path lies ~4 se out
    check(abs(m_d - mu_true) < 0.03,
          "gaussian toy mean over seeds off the analytic mean by >= 0.03")
    check(abs(gap_se) < 4.0, "gaussian toy: card and CPU means differ by "
          ">= 4 standard errors")


def lotka_volterra(dev, adaptive: bool, gens: int) -> dict[str, int]:
    """LV config 2 (``adaptive``) or the same run under a fixed p-norm."""
    import numpy as np
    import torch

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pyabc_tpu_torch.models import lotka_volterra as lv

    label = "LV config 2" if adaptive else "LV fixed p-norm"
    dist = (pt.AdaptivePNormDistance(p=2) if adaptive
            else pt.PNormDistance(p=2))
    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(), dist,
                    population_size=POP, eps=pt.MedianEpsilon(), seed=0,
                    device=dev)
    abc.new("sqlite://", lv.observed_data(seed=0), store_sum_stats=False)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    h = abc.run(max_nr_populations=gens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    pops = h.get_all_populations()[1:]
    eps = [float(e) for e in pops["epsilon"]]
    n_gen = len(eps)
    syncs = abc.sync_ledger.summary()
    rounds = [g["rounds"] for g in abc.generation_log]
    df, w = h.get_distribution()
    means = {k: float(np.sum(df[k] * w)) for k in lv.TRUE_PARS}
    log(f"{label}: pop={POP} gens={n_gen} wall_s={wall:.3f} "
        f"accepted_particles_per_s={POP * n_gen / wall:.1f} "
        f"wall_s_per_generation={wall / n_gen:.4f} "
        f"syncs_per_generation={syncs['syncs'] / n_gen:.2f} "
        f"(rounds {rounds}, {syncs['by_kind']})")
    split = {k: sum(g[k] for g in abc.generation_log)
             for k in ("compute_s", "fetch_s", "persist_s")}
    log(f"{label}: host seconds, rounds + generation steps "
        f"{split['compute_s']:.4f}, packed fetch {split['fetch_s']:.4f}, "
        f"History persist {split['persist_s']:.4f}, other "
        f"{wall - sum(split.values()):.4f}")
    log(f"{label}: eps trail {[round(e, 4) for e in eps]}")
    log(f"{label}: posterior means {means} true {lv.TRUE_PARS}")
    log(f"{label}: kernel launches {counts}")
    check(n_gen == gens, f"LV ran {n_gen} of {gens} generations")
    if adaptive:
        # under adaptive weights each epsilon is a quantile in a new
        # distance space, so the trail need not fall every generation (the
        # JAX package's own trail rises at generations 2-4 of this config,
        # see tests/test_torch_slice.py); it must fall over the run
        check(eps[-1] < 0.5 * eps[0], "LV epsilon trail did not fall")
    else:
        check(all(b <= a for a, b in zip(eps, eps[1:])),
              "LV epsilons increased under a fixed distance")
    check(all(v > 0 for v in counts.values()),
          "a kernel of the path was never launched")
    check(all(math.isfinite(v) for v in means.values()),
          "non-finite LV posterior mean")
    for t in range(n_gen):
        dmax = float(h.get_weighted_distances(t)["distance"].max())
        check(dmax <= eps[t], f"LV generation {t} stored a distance "
              f"{dmax} above its epsilon {eps[t]}")
    prior_sd = {k: rv.scale / math.sqrt(12.0)
                for k, rv in lv.default_prior().rv_map.items()}
    post_sd = {k: float(np.sqrt(np.sum(w * (df[k] - means[k]) ** 2)))
               for k in means}
    log(f"{label}: posterior sd {post_sd} prior sd {prior_sd}")
    if adaptive:
        check(all(post_sd[k] < prior_sd[k] for k in means),
              "LV posterior did not concentrate (sd >= the prior sd)")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    import pyabc_tpu_torch  # noqa: F401 - fails outside a checkout
    from pyabc_tpu_torch.kernels import KERNELS, _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} capability {cap}")
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build+load {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")

    results = kernel_checks(dev)
    for name, r in results.items():
        log(f"{name}: ms={r['ms']:.5f} call_ms={r['call_ms']:.5f} "
            f"plain_ms={r['plain_ms']:.5f} "
            f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]}) "
            f"library_ms={r['library_ms']}")
    gaussian_toy(dev)
    lotka_volterra(dev, adaptive=False, gens=6)
    counts = lotka_volterra(dev, adaptive=True, gens=10)

    kernels = []
    for k in KERNELS:
        r = results[k.name]
        kernels.append({
            "name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces, "launches": counts[k.name],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
