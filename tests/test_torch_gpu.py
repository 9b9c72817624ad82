"""Card tests: each hand-written kernel (K2 with K1, K3-K26, K6's
record mode and K24's shard modes) against its plain PyTorch version on
the CUDA device, at small shapes and at the main-path shapes of BASELINE
configs 2 and 4. Marked ``gpu``; without a card
every test skips (the decision is taken in a fixture, so every worker
collects the same tests).

Run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``
(``tests/conftest.py`` imports JAX, which the port's machine needs not have).
"""
import math

import numpy as np
import pytest
import torch

from pyabc_tpu_torch import RV, Distribution
from pyabc_tpu_torch.kernels import (cast_rows_plain, compact_round,
                                     compact_round_plain, generation_health,
                                     generation_health_plain, lv_simulate,
                                     lv_simulate_plain, mvn_fit,
                                     mvn_fit_plain, mvn_mixture_logpdf,
                                     mvn_mixture_logpdf_plain,
                                     normalize_log_weights_plain,
                                     normalize_quantile, pack_fetch,
                                     pack_rows_plain, philox,
                                     pnorm_accept_weight,
                                     pnorm_accept_weight_plain, propose,
                                     propose_plain, scale_reduce,
                                     scale_reduce_plain,
                                     weighted_quantile_plain)
from pyabc_tpu_torch.kernels.moments import SCALE_NAMES as MOMENT_SCALES
from pyabc_tpu_torch.kernels.mvn_fit import (chol_guarded_cuda,
                                             device_chol_guarded)
from pyabc_tpu_torch.kernels.philox import philox_blocks_cuda
from pyabc_tpu_torch.kernels.scale_reduce import SCALE_NAMES
from pyabc_tpu_torch.models import lotka_volterra as lv
from pyabc_tpu_torch.transition import (MultivariateNormalTransition,
                                        scott_rule_of_thumb,
                                        silverman_rule_of_thumb)

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)

SHAPES = [(64, 64), (4096, 1024)]  # (lanes B, reservoir n_cap)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _lv_round(dev, B):
    g = _gen(dev)
    model, prior = lv.make_lv_model(), lv.default_prior()
    theta = prior.rvs_array(B, g, dev)
    noise = torch.randn(B, 2, model.n_obs, generator=g, device=dev)
    kw = dict(n_obs=model.n_obs, n_substeps=model.n_substeps, dt=model.dt,
              y0=lv.Y0, noise_sd=model.noise_sd, log_parameters=False)
    return theta, noise, kw


@pytest.mark.parametrize("B,n", SHAPES)
def test_lv_simulate_kernel(dev, B, n):
    theta, noise, kw = _lv_round(dev, B)
    theta[0, 0] = float("nan")
    stream = _stream(dev, philox.SIM_NOISE, seed=B)
    before = lv_simulate.launches
    got = lv_simulate(theta, None, stream=stream, **kw)
    assert lv_simulate.launches == before + 1
    ref = lv_simulate_plain(theta, None, stream=stream, **kw)
    # on the card the noise is drawn in the kernel, never given
    with pytest.raises(ValueError):
        lv_simulate(theta, noise, **kw)
    assert torch.equal(got.isnan(), ref.isnan())
    fin = ref.isfinite()
    # FMA contraction over 190 RK4 steps: |err| <= 1e-3 + 1e-4 |x|
    assert bool(((got - ref).abs()[fin]
                 <= 1e-3 + 1e-4 * ref.abs()[fin]).all())


@pytest.mark.parametrize("B,n", SHAPES)
@pytest.mark.parametrize("d", [1, 4, 7])
def test_mvn_mixture_logpdf_kernel(dev, B, n, d):
    g = _gen(dev, d)
    thetas = torch.randn(n, d, generator=g, device=dev) + 3.0
    w = torch.rand(n, generator=g, device=dev)
    w[n // 2:] = 0.0
    params = MultivariateNormalTransition.device_fit(
        thetas, w / w.sum(), dim=d, scaling=1.0,
        bandwidth_selector=silverman_rule_of_thumb)
    q = MultivariateNormalTransition.device_rvs(
        params, B, _stream(dev, philox.TRANSITION, seed=d))
    got = mvn_mixture_logpdf(q, params)
    ref = mvn_mixture_logpdf_plain(q, params)
    # float32 logsumexp over n terms in another order
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
    zero = dict(params, weights=torch.zeros_like(params["weights"]))
    assert bool(mvn_mixture_logpdf(q, zero).isneginf().all())


def test_mvn_rejects_wrong_input(dev):
    params = MultivariateNormalTransition.zero_params(8, 2, dev)
    with pytest.raises(TypeError):
        mvn_mixture_logpdf(torch.zeros(4, 2, dtype=torch.float64,
                                       device=dev), params)
    with pytest.raises(ValueError):
        mvn_mixture_logpdf(torch.zeros(4, 3, device=dev), params)
    with pytest.raises(ValueError):
        mvn_mixture_logpdf(torch.zeros(4, 2), params)  # mixed devices


@pytest.mark.parametrize("B,n", SHAPES)
@pytest.mark.parametrize("p", [1.0, 2.0, math.inf, 3.0])
def test_pnorm_accept_weight_kernel(dev, B, n, p):
    theta, noise, kw = _lv_round(dev, B)
    ss = lv_simulate_plain(theta, noise, **kw)
    g = _gen(dev, 1)
    x0 = ss[0].clone()
    w = torch.rand(ss.shape[1], generator=g, device=dev) + 0.1
    valid = torch.rand(B, generator=g, device=dev) > 0.1
    logpri = torch.randn(B, generator=g, device=dev)
    logq = torch.randn(B, generator=g, device=dev)
    d_all = pnorm_accept_weight_plain(ss, x0, w, torch.tensor(
        math.inf, device=dev), valid, p=p)[0]
    eps = d_all.nanmedian()
    hist = d_all.nanquantile(0.4)
    args = (ss, x0, w, eps, valid)
    kw5 = dict(p=p, logpri=logpri, logq=logq, hist_min=hist)
    d, a, lw = pnorm_accept_weight(*args, **kw5)
    d_r, a_r, lw_r = pnorm_accept_weight_plain(*args, **kw5)
    torch.testing.assert_close(d, d_r, rtol=1e-5, atol=0, equal_nan=True)
    far = (d_r - torch.minimum(eps, hist)).abs() > 1e-5 * eps
    assert torch.equal(a[far], a_r[far])
    assert torch.equal(lw, lw_r)


@pytest.mark.parametrize("B,n", SHAPES)
def test_compact_round_kernel(dev, B, n):
    g = _gen(dev, 2)
    S, d, rec_cap = 40, 4, 3 * B // 2
    theta = torch.randn(B, d, generator=g, device=dev)
    ss = torch.randn(B, S, generator=g, device=dev)
    dist = torch.rand(B, generator=g, device=dev)
    logw = torch.randn(B, generator=g, device=dev)

    def bufs():
        res = {"theta": torch.zeros(n, d, device=dev),
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

    (rk, ck), (rp, cp) = bufs(), bufs()
    ctr_k = torch.zeros(4, dtype=torch.int32, device=dev)
    ctr_p = torch.zeros(4, dtype=torch.int32, device=dev)
    # three rounds: the reservoir overflows, the ring fills mid-round
    for _ in range(3):
        accept = torch.rand(B, generator=g, device=dev) < 0.6
        valid = torch.rand(B, generator=g, device=dev) < 0.9
        compact_round(accept, valid, theta, ss, dist, logw, rk, ck, ctr_k)
        compact_round_plain(accept, valid, theta, ss, dist, logw, rp, cp,
                            ctr_p)
    assert torch.equal(ctr_k, ctr_p) and int(ctr_k[0]) > n
    for a, b in [*zip(rk.values(), rp.values()),
                 *zip(ck.values(), cp.values())]:
        assert torch.equal(a, b)


def test_lv_run_on_the_card(dev):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts

    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.AdaptivePNormDistance(p=2), population_size=200,
                    seed=0, device=dev)
    abc.new("sqlite://", lv.observed_data(seed=0), store_sum_stats=False)
    reset_launch_counts()
    h = abc.run(max_nr_populations=4)
    assert h.n_populations == 4
    # every kernel of the LV path (the noisy-ABC kernels, the model
    # selection's K20b and K26, config 3's K18, K19 and K20b network,
    # LocalTransition's K12-K15, the segmented family's K20b and K22, the
    # adaptive population size's K16, the aggregated distances' K25, the
    # learned statistics' K23 (linear and MLP) and K18 operands, the
    # host-refit mode's GP transform, GridSearchCV's K17, config 1's
    # Gaussian simulator, sharded sampling's K24b and K25's sharded finish,
    # the mesh's K24e pack and unpack, the conjugate toy's mean-only
    # simulator are not on it)
    noisy = ("sir_simulate", "kernel_accept", "temperature_update",
             "ode_family_simulate", "model_step", "segment_round",
             "tau_leap", "network_sir", "local_cov", "local_factor",
             "propose_local", "local_logpdf", "proposal_drift",
             "ode_family_segments", "moment_fold", "moment_finish",
             "bootstrap_cv", "aggregate_accept_weight", "aggregate_refit",
             "ridge_fit", "linear_accept", "linear_bound", "mlp_fit",
             "mlp_accept", "gp_accept", "grid_search_cv",
             "gaussian_simulate", "shard_mask", "aggregate_finish",
             "mesh_pack", "mesh_unpack", "mean_only_simulate")
    counts = launch_counts()
    assert all(v > 0 for k, v in counts.items() if k not in noisy)
    assert all(counts[k] == 0 for k in noisy)
    eps = np.asarray(h.get_all_populations()["epsilon"][1:])
    assert np.all(np.isfinite(eps)) and eps[-1] < eps[0]


# ------------------------------------------------------ K1, K2, K7, K8, K9
KAT = [  # Random123's known-answer vectors for Philox4x32-10
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers_on_card(dev, case):
    ctr, key, want = KAT[case]
    words, _u, _z = philox_blocks_cuda(
        torch.tensor([ctr], dtype=torch.int64, device=dev), key)
    assert words[0].tolist() == list(want)


def test_philox_card_matches_plain(dev):
    rng = np.random.default_rng(0)
    ctr = torch.from_numpy(rng.integers(0, 2 ** 32, size=(4096, 4),
                                        dtype=np.int64)).to(dev)
    key = (0x12345678, 0x9abcdef0)
    words, uni, nrm = philox_blocks_cuda(ctr, key)
    w = philox.philox4x32_10(*ctr.unbind(1), key)
    assert torch.equal(words, torch.stack(w, dim=1))
    u = [philox.uniform_of(x) for x in w]
    assert torch.equal(uni, torch.stack(u, dim=1))  # bit-exact
    z = torch.stack([philox.box_muller(u[0], u[1], False),
                     philox.box_muller(u[0], u[1], True),
                     philox.box_muller(u[2], u[3], False),
                     philox.box_muller(u[2], u[3], True)], dim=1)
    # logf / sinf / cosf against PyTorch's: abs 2e-6 at |z| <= 5.8
    assert float((nrm - z).abs().max()) <= 2e-6
    assert float(uni.min()) > 0.0 and float(uni.max()) < 1.0


def _fit(dev, n, d, seed=0, dim=None, n_empty=None):
    g = _gen(dev, seed)
    thetas = torch.randn(n, d, generator=g, device=dev) * 0.3 + 1.0
    w = torch.rand(n, generator=g, device=dev)
    n_empty = n // 5 if n_empty is None else n_empty
    if n_empty:
        w[n - n_empty:] = 0.0
        thetas[n - n_empty:] = 0.0
    return thetas, w / w.sum(), d if dim is None else dim


def _stream(dev, tag, rounds=3, gen=2, seed=7):
    ctr = torch.zeros(4, dtype=torch.int32, device=dev)
    ctr[1] = rounds
    return philox.PhiloxStream(seed, gen, tag, 256, ctr)


def _near_bounds(theta, prior, tol=1e-4):
    lo, hi = prior["loc"], prior["hi"]
    unif = prior["kind"] == 1
    near = ((theta - lo).abs() < tol) | ((theta - hi).abs() < tol)
    return (near & unif).any(dim=1)


@pytest.mark.parametrize("B,n", SHAPES)
@pytest.mark.parametrize("d", [1, 4, 7])
def test_propose_kernel(dev, B, n, d):
    thetas, w, _ = _fit(dev, n, d, seed=d)
    params = mvn_fit_plain(thetas, w, dim=d, scaling=1.0,
                           bandwidth_selector=silverman_rule_of_thumb)
    prior = Distribution(**{f"p{k}": RV("uniform" if k % 2 else "norm",
                                        0.5 if k % 2 else 1.0, 1.0)
                            for k in range(d)}).arrays(dev)
    for tag, p in ((philox.PRIOR, None), (philox.TRANSITION, params)):
        stream = _stream(dev, tag)
        before = propose.launches
        th_k, lp_k, v_k = propose(stream, B, prior, p)
        assert propose.launches == before + 1
        th_p, lp_p, v_p = propose_plain(stream, B, prior, p)
        # a lane whose draw sits within rounding of a uniform bound may
        # take another redraw; the normals differ by 2e-6 at most
        odd = (v_k != v_p) | ((th_k - th_p).abs()
                              > 1e-5 + 1e-5 * th_p.abs()).any(dim=1)
        assert bool(_near_bounds(th_p[odd], prior).all())
        ok = ~odd & v_p
        assert int(ok.sum()) > B // 2
        assert float((lp_k - lp_p)[ok].abs().max()) <= 1e-5


#: K2's family mode: one prior of each family (and the decorator)
FAMILY_SPECS = [("lognorm", 0.5, 0.0, 1.5), ("expon", 0.2, 1.5),
                ("gamma", 2.0, 0.0, 0.5), ("gamma", 0.3),
                ("beta", 0.2, 0.3), ("laplace", 0.0, 1.0),
                ("cauchy", 0.0, 1.0), ("t", 3.0, 0.0, 1.0),
                ("truncnorm", -1.0, 2.0, 0.0, 1.0), ("randint", 2, 9),
                ("binom", 20, 0.3), ("binom", 100, 0.7), ("poisson", 40.0),
                ("nbinom", 5.0, 0.4), ("bound",)]


@pytest.mark.parametrize("spec", FAMILY_SPECS, ids=lambda s: "-".join(
    map(str, s)))
@pytest.mark.parametrize("B", [257, 65536])
def test_propose_family_kernel(dev, spec, B):
    """K2's family mode against its plain version: prior-mode draws within
    abs 1e-5 + rel 1e-5 on all but 1e-3 of the lanes, log-densities within
    abs 1e-5 + rel 1e-5 with equal -inf masks, and the transition mode
    over points inside and outside the support."""
    from pyabc_tpu_torch import LowerBoundDecorator

    rv = (LowerBoundDecorator(RV("norm", 0.1, 0.1), 0.0)
          if spec[0] == "bound" else RV(*spec))
    prior = Distribution(x=rv).arrays(dev)
    pts = torch.linspace(-3.0, 12.0, 301, device=dev)[:, None]
    w = torch.full((301,), 1.0 / 301, device=dev)
    fit = {"thetas": pts.contiguous(), "cdf": torch.cumsum(w, 0),
           "chol": torch.zeros(1, 1, device=dev)}
    for tag, p in ((philox.PRIOR, None), (philox.TRANSITION, fit)):
        stream = _stream(dev, tag)
        before = propose.mode_launches["families"]
        th_k, lp_k, v_k = propose(stream, B, prior, p)
        assert propose.mode_launches["families"] == before + 1
        th_p, lp_p, v_p = propose_plain(stream, B, prior, p)
        apart = (v_k != v_p) | ((th_k - th_p).abs()
                                > 1e-5 + 1e-5 * th_p.abs()).any(dim=1)
        assert int(apart.sum()) <= max(1, B // 1000)
        ok = ~apart
        assert torch.equal(torch.isfinite(lp_k)[ok],
                           torch.isfinite(lp_p)[ok])
        fin = ok & torch.isfinite(lp_p)
        torch.testing.assert_close(lp_k[fin], lp_p[fin], rtol=1e-5,
                                   atol=1e-5)
    if spec[0] == "bound":
        th = propose(_stream(dev, philox.PRIOR), B, prior)[0]
        assert bool((th > 0).all())


def test_propose_local_family_kernel(dev):
    """K2's local mode under the LV families leg's prior: theta, valid and
    the log-densities as the plain version's."""
    from pyabc_tpu_torch import LowerBoundDecorator
    from pyabc_tpu_torch.kernels import propose_local, propose_local_plain

    prior = Distribution(
        a=RV("gamma", 2.0, 0.0, 0.75), b=RV("lognorm", 0.8, 0.0, 0.12),
        c=RV("truncnorm", -1.5, 1.5, 1.5, 1.0),
        d=LowerBoundDecorator(RV("norm", 0.1, 0.1), 0.0)).arrays(dev)
    g = _gen(dev, 3)
    n, B = 1024, 65536
    thetas = torch.rand(n, 4, generator=g, device=dev) * 2
    w = torch.full((n,), 1.0 / n, device=dev)
    params = {"thetas": thetas, "cdf": torch.cumsum(w, 0),
              "chols": torch.eye(4, device=dev).expand(n, 4, 4).mul(0.2)
              .contiguous()}
    stream = _stream(dev, philox.TRANSITION)
    th_k, lp_k, v_k = propose_local(stream, B, prior, params)
    th_p, lp_p, v_p = propose_local_plain(stream, B, prior, params)
    apart = (v_k != v_p) | ((th_k - th_p).abs()
                            > 1e-5 + 1e-5 * th_p.abs()).any(dim=1)
    assert int(apart.sum()) <= B // 1000
    fin = ~apart & torch.isfinite(lp_p)
    torch.testing.assert_close(lp_k[fin], lp_p[fin], rtol=1e-5, atol=1e-5)


def test_propose_legacy_priors_skip_the_family_mode(dev):
    """A norm/uniform prior runs the kernel's first code, outside the
    family mode, and draws what its plain version draws."""
    prior = lv.default_prior().arrays(dev)
    assert not prior["families"]
    stream = _stream(dev, philox.PRIOR)
    before = propose.mode_launches["families"]
    th_k = propose(stream, 4096, prior)[0]
    assert propose.mode_launches["families"] == before
    torch.testing.assert_close(th_k, propose_plain(stream, 4096, prior)[0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [64, 1024, 5000])
def test_normalize_quantile_kernel(dev, n):
    g = _gen(dev, n)
    lw = torch.randn(n, generator=g, device=dev) * 5 - 40
    mask = torch.rand(n, generator=g, device=dev) < 0.8
    for m in (mask, torch.zeros_like(mask), None):
        got = normalize_quantile.normalize(lw, m)
        ref = normalize_log_weights_plain(lw, m)
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-12)
    w = normalize_log_weights_plain(lw, mask)
    pts = torch.rand(n, generator=g, device=dev).mul(8).floor()  # ties
    pts = torch.where(mask, pts, torch.full_like(pts, math.inf))
    # alpha = 1 with float weights lies on a step: the plain cumsum may
    # absorb the last tiny weights in float32, the kernel sums in double
    cases = [(a, wts) for a in (0.1, 0.5, 0.9)
             for wts in (w, mask.float(), torch.zeros_like(w))]
    for alpha, wts in cases + [(1.0, mask.float())]:
        got = normalize_quantile.quantile(pts, wts, alpha)
        ref = weighted_quantile_plain(pts, wts, alpha)
        assert float(got) == float(ref), (alpha, float(got), float(ref))


@pytest.mark.parametrize("n,d,dim", [(64, 1, 1), (1024, 4, 4), (1024, 7, 5),
                                     (333, 4, 4), (16384, 4, 4),
                                     (4096, 2, 1)])
def test_mvn_fit_kernel(dev, n, d, dim):
    """K8 against its plain version (its moments and factorization live in
    ``csrc/mvn_fit.cuh``, shared with K16's bootstrap fit: the same
    tolerances, at the adaptive legs' widths too)."""
    thetas, w, dim = _fit(dev, n, d, seed=n + d, dim=dim)
    for sel in (silverman_rule_of_thumb, scott_rule_of_thumb):
        before = mvn_fit.launches
        got = mvn_fit(thetas, w, dim=dim, scaling=1.0,
                      bandwidth_selector=sel)
        assert mvn_fit.launches == before + 1
        ref = mvn_fit_plain(thetas, w, dim=dim, scaling=1.0,
                            bandwidth_selector=sel)
        # weighted moments summed in another order: rel 1e-5; the centred
        # rows inherit the mean's absolute error (rel 1e-5 of |center|)
        for k in ("thetas", "weights", "center", "cdf"):
            torch.testing.assert_close(got[k], ref[k], rtol=1e-5,
                                       atol=1e-7, msg=k)
        torch.testing.assert_close(got["thetas_c"], ref["thetas_c"],
                                   rtol=1e-5, atol=1e-5 * float(
                                       ref["center"].abs().max()))
        for k in ("chol", "prec", "logdet", "quad"):
            torch.testing.assert_close(got[k], ref[k], rtol=1e-4,
                                       atol=1e-5, msg=k)


@pytest.mark.parametrize("x,rung", [(-1e-11, 1), (-1e-9, 2), (-1e-6, 3),
                                    (-1.0, 4), (1.0, 0)])
def test_chol_ladder_rungs_on_card(dev, x, rung):
    cov = torch.diag(torch.tensor([1.0, 2.0, 0.5, x], device=dev))
    cov[0, 1] = cov[1, 0] = 0.3
    chol, used, got = chol_guarded_cuda(cov)
    assert int(got) == rung
    ref_chol, ref_used, bad = device_chol_guarded(cov)
    assert bool(bad) == (rung == 4)
    torch.testing.assert_close(used, ref_used, rtol=1e-6, atol=0)
    torch.testing.assert_close(chol, ref_chol, rtol=1e-5, atol=1e-7,
                               equal_nan=True)


@pytest.mark.parametrize("n,S", [(8192, 40), (63, 1), (64, 3)])
@pytest.mark.parametrize("name", SCALE_NAMES)
def test_scale_reduce_kernel(dev, n, S, name):
    g = _gen(dev, S)
    samples = torch.randn(n, S, generator=g, device=dev) * 3 + 2
    samples[:, 0] = samples[:, 0].round()  # ties at the median
    valid = torch.rand(n, generator=g, device=dev) < 0.7
    rows = torch.randn(64, S, generator=g, device=dev)
    x0 = torch.randn(S, generator=g, device=dev)
    if S > 2:
        samples[5, 2] = math.nan  # a blown-up lane in a valid row
        valid[5] = True
    for ratio in (None, 5.0):
        kw = dict(scale_name=name, max_weight_ratio=ratio,
                  normalize_weights=True, rows=rows, p=2.0)
        sc, w, d = scale_reduce(samples, valid, x0, **kw)
        sc_p, w_p, d_p = scale_reduce_plain(samples, valid, x0, **kw)
        if "median" in name:
            assert torch.equal(sc.isnan(), sc_p.isnan())
            fin = ~sc_p.isnan()
            assert torch.equal(sc[fin], sc_p[fin]), name  # bit-exact
        else:
            torch.testing.assert_close(sc, sc_p, rtol=1e-5, atol=1e-6,
                                       equal_nan=True)
        torch.testing.assert_close(w, w_p, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(d, d_p, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)


@pytest.mark.parametrize("B", [64, 4096])
def test_lv_philox_noise_kernel(dev, B):
    theta, _noise, kw = _lv_round(dev, B)
    stream = _stream(dev, philox.SIM_NOISE)
    got = lv_simulate(theta, None, stream=stream, **kw)
    ref = lv_simulate_plain(theta, None, stream=stream, **kw)
    assert torch.equal(got.isnan(), ref.isnan())
    fin = ref.isfinite()
    assert bool(((got - ref).abs()[fin]
                 <= 1e-3 + 1e-4 * ref.abs()[fin]).all())


# ------------------------------------------------------------- K10, K11
EDGE_VALUES = [-0.6001, -0.0, 0.0, 1e-7, 3e-5, 0.6001, 65519.0, 65520.0,
               7e4, 3.4e38, math.nan, math.inf, -math.inf]


@pytest.mark.parametrize("G", [1, 8, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_pack_fetch_kernel(dev, G, dtype):
    """Bit-identical to the plain version, over the cast's edge values and
    more generations than one launch takes (40 > 32)."""
    g = _gen(dev, G)
    n_cap, n_keep, d, S = 1024, 1000, 4, 40
    theta = [torch.randn(n_cap, d, generator=g, device=dev) * 3
             for _ in range(G)]
    dist = [torch.rand(n_cap, generator=g, device=dev) for _ in range(G)]
    logw = [torch.randn(n_cap, generator=g, device=dev) for _ in range(G)]
    ss = [torch.randn(n_cap, S, generator=g, device=dev) * 1e4
          for _ in range(G)]
    edge = torch.tensor(EDGE_VALUES, device=dev)
    k = edge.numel()
    dist[0][:k] = theta[-1][:k, 1] = logw[G // 2][:k] = ss[0][:k, 2] = edge
    before = pack_fetch.launches
    got = pack_fetch.rows(theta, dist, logw, n_keep=n_keep, dtype=dtype)
    got_ss = pack_fetch.sumstats(ss, n_keep=n_keep, dtype=dtype)
    assert pack_fetch.launches == before + 2 * math.ceil(G / 32)
    ref = pack_rows_plain(theta, dist, logw, n_keep=n_keep, dtype=dtype)
    ref_ss = cast_rows_plain(ss, n_keep=n_keep, dtype=dtype)
    for a, b in ((got, ref), (got_ss, ref_ss)):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a[~a.isnan()], b[~b.isnan()])


def _health_case(dev, kind, n_cap=1024, d=4, n_keep=1000):
    g = _gen(dev, n_cap)
    thetas, w, _dim = _fit(dev, n_cap, d, seed=3, dim=d)
    params = mvn_fit_plain(thetas, w, dim=d, scaling=1.0,
                           bandwidth_selector=silverman_rule_of_thumb)
    params_next = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                   for k, v in params.items()}
    k_mask = torch.arange(n_cap, device=dev) < n_keep
    w_norm = torch.where(k_mask, w, torch.zeros_like(w))
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa
    x = dict(theta=torch.randn(n_cap, d, generator=g, device=dev),
             k_mask=k_mask, w_norm=w_norm,
             d_new=torch.rand(n_cap, generator=g, device=dev),
             n_acc=torch.tensor(n_keep, dtype=torch.int32, device=dev),
             n_target=n_keep, acc_rate=f(0.25), trans_params=params,
             trans_next=params_next,
             fitted=torch.tensor(True, device=dev),
             fitted_next=torch.tensor(True, device=dev), eps_g=f(0.5),
             eps_next=f(0.4), eps_prev=f(1.0),
             stall_count=torch.tensor(1, dtype=torch.int32, device=dev),
             ess_floor=0.05, acc_floor=0.2, stall_window=2, stall_rtol=1e-3)
    if kind == "nan_theta":
        x["theta"][n_keep - 1, d - 1] = math.nan
    elif kind == "nan_masked_rows":
        x["theta"][n_keep, 0] = math.inf
        x["d_new"][n_cap - 1] = math.nan
    elif kind == "nan_weight":
        x["w_norm"][0] = math.nan
    elif kind == "ess_floor":
        x["ess_floor"] = 0.99
    elif kind == "psd":
        params_next["chol"][1, 0] = math.nan
    elif kind == "zero_weights":
        params["weights"].zero_()
    elif kind == "unfitted":
        params["chol"].fill_(math.nan)
        x["fitted"] = torch.tensor(False, device=dev)
    elif kind == "stall":
        x["eps_prev"] = f(0.5 * (1 + 1e-4))
    elif kind == "eps_nonfinite":
        x["eps_g"] = f(math.nan)
    elif kind == "all_masked":
        x["k_mask"] = torch.zeros_like(k_mask)
        x["w_norm"] = torch.zeros_like(w_norm)
        x["n_acc"] = torch.tensor(0, dtype=torch.int32, device=dev)
        x["fitted_next"] = torch.tensor(False, device=dev)
    return x


@pytest.mark.parametrize("kind", ["ok", "nan_theta", "nan_masked_rows",
                                  "nan_weight", "ess_floor", "psd",
                                  "zero_weights", "unfitted", "stall",
                                  "eps_nonfinite", "all_masked"])
def test_generation_health_kernel(dev, kind):
    x = _health_case(dev, kind)
    before = generation_health.launches
    word, ess, eps_prev, stall = generation_health(**x)
    assert generation_health.launches == before + 1
    r_word, r_ess, r_prev, r_stall = generation_health_plain(**x)
    assert int(word) == int(r_word), kind
    assert int(stall) == int(r_stall) and eps_prev is x["eps_g"]
    # sum of squared weights in another order: rel 1e-5
    torch.testing.assert_close(ess, r_ess, rtol=1e-5, atol=0,
                               equal_nan=True)
    assert (int(word) == 0) == (kind in ("ok", "nan_masked_rows",
                                         "unfitted", "all_masked"))


# ------------------------------------------- K20, K21a, K21b, K6 records
def _sir_round(dev, B):
    from pyabc_tpu_torch.models import sir

    g = _gen(dev, 20)
    theta = sir.default_prior().rvs_array(B, g, dev)
    theta[:4] = torch.tensor([[0.05, 0.01], [1.0, 0.5], [0.05, 0.5],
                              [1.0, 0.01]], device=dev)
    model = sir.make_sir_model()
    kw = dict(n_obs=model.n_obs, n_substeps=model.n_substeps, dt=model.dt,
              n_pop=sir.N_POP)
    return theta.contiguous(), kw


@pytest.mark.parametrize("B", [77, 4096])
@pytest.mark.parametrize("noise_sd", [0.0, 10.0])
def test_sir_simulate_kernel(dev, B, noise_sd):
    from pyabc_tpu_torch.kernels import sir_simulate, sir_simulate_plain

    theta, kw = _sir_round(dev, B)
    stream = _stream(dev, philox.SIM_NOISE, seed=B) if noise_sd else None
    before = sir_simulate.launches
    got = sir_simulate(theta, noise_sd=noise_sd, stream=stream, **kw)
    assert sir_simulate.launches == before + 1
    ref = sir_simulate_plain(theta, noise_sd=noise_sd, stream=stream, **kw)
    assert got.shape == (B, 15) and bool(got.isfinite().all())
    # FMA contraction over 112 RK4 steps: |err| <= 1e-3 + 1e-4 |x|
    assert bool(((got - ref).abs() <= 1e-3 + 1e-4 * ref.abs()).all())


def _noisy_round(dev, B):
    from pyabc_tpu_torch.models import sir

    theta, kw = _sir_round(dev, B)
    from pyabc_tpu_torch.kernels import sir_simulate_plain
    ss = sir_simulate_plain(theta, **kw)
    x0 = torch.as_tensor(sir.observed_data(seed=11)["infected"],
                         dtype=torch.float32, device=dev)
    var = torch.full((15,), 100.0, device=dev)
    return theta, ss, x0, var


@pytest.mark.parametrize("B", [77, 4096])
@pytest.mark.parametrize("mode", ["prior", "transition", "lin"])
def test_kernel_accept_kernel(dev, B, mode):
    from pyabc_tpu_torch.kernels import kernel_accept, kernel_accept_plain
    from pyabc_tpu_torch.kernels.kernel_accept import accept_uniforms

    _theta, ss, x0, var = _noisy_round(dev, B)
    g = _gen(dev, 21)
    valid = torch.rand(B, generator=g, device=dev) > 0.05
    temp = torch.tensor(300.0, device=dev)
    pdf_norm = torch.tensor(-48.3, device=dev)
    kw = dict(stream=_stream(dev, philox.ACCEPT, seed=B), lin=mode == "lin",
              apply_iw=True)
    if mode == "transition":
        kw.update(logpri=torch.randn(B, generator=g, device=dev),
                  logq=torch.randn(B, generator=g, device=dev))
    args = (ss, x0, var, temp, pdf_norm, valid)
    v, a, lw = kernel_accept(*args, **kw)
    v_r, a_r, lw_r = kernel_accept_plain(*args, **kw)
    # 15 float32 terms summed in another order: rel 1e-5
    torch.testing.assert_close(v, v_r, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(lw, lw_r, rtol=1e-5, atol=1e-5)
    ratio = ((torch.log(v_r.clamp_min(1e-30)) if mode == "lin" else v_r)
             - pdf_norm) / temp
    logu = torch.log(accept_uniforms(kw["stream"], B))
    clear = (logu - ratio).abs() > 1e-5 * (1 + ratio.abs())
    assert torch.equal(a[clear], a_r[clear])
    assert not bool(a[~valid].any())


@pytest.mark.parametrize("B,n", SHAPES)
def test_compact_round_record_mode_kernel(dev, B, n):
    g = _gen(dev, 6)
    S, d, rec_cap = 15, 2, 3 * B // 2
    theta = torch.randn(B, d, generator=g, device=dev)
    ss = torch.randn(B, S, generator=g, device=dev)
    dist = torch.randn(B, generator=g, device=dev)
    logw = torch.randn(B, generator=g, device=dev)
    logq = torch.randn(B, generator=g, device=dev)

    def bufs():
        res = {"theta": torch.zeros(n, d, device=dev),
               "sumstats": torch.zeros(n, S, device=dev),
               "distance": torch.zeros(n, device=dev),
               "log_weight": torch.full((n,), -math.inf, device=dev),
               "slot": torch.full((n,), -1, dtype=torch.int32, device=dev)}
        rec = {"sumstats": torch.zeros(rec_cap, S, device=dev),
               "distance": torch.zeros(rec_cap, device=dev),
               "accepted": torch.zeros(rec_cap, dtype=torch.bool,
                                       device=dev),
               "valid": torch.zeros(rec_cap, dtype=torch.bool, device=dev),
               "theta": torch.zeros(rec_cap, d, device=dev),
               "logq": torch.zeros(rec_cap, device=dev)}
        return res, rec

    (rk, ck), (rp, cp) = bufs(), bufs()
    ctr_k = torch.zeros(4, dtype=torch.int32, device=dev)
    ctr_p = torch.zeros(4, dtype=torch.int32, device=dev)
    for _ in range(3):
        accept = torch.rand(B, generator=g, device=dev) < 0.6
        valid = torch.rand(B, generator=g, device=dev) < 0.9
        compact_round(accept, valid, theta, ss, dist, logw, rk, ck, ctr_k,
                      logq=logq)
        compact_round_plain(accept, valid, theta, ss, dist, logw, rp, cp,
                            ctr_p, logq)
    assert torch.equal(ctr_k, ctr_p)
    for a, b in [*zip(rk.values(), rp.values()),
                 *zip(ck.values(), cp.values())]:
        assert torch.equal(a, b)
    # the ring keeps the valid lanes of the first 1.5 rounds
    assert int(ck["valid"].sum()) > B and not bool(ck["valid"].all())


def _temp_inputs(dev, n_cap, rec_cap, n_keep, n_valid, seed=0):
    g = _gen(dev, seed)
    d = 2
    k_mask = torch.arange(n_cap, device=dev) < n_keep
    w = torch.where(k_mask, torch.rand(n_cap, generator=g, device=dev),
                    torch.zeros(n_cap, device=dev))
    res_theta = torch.randn(n_cap, d, generator=g, device=dev) * 0.1 + 0.4
    params = MultivariateNormalTransition.device_fit(
        res_theta, w / w.sum(), dim=d, scaling=1.0,
        bandwidth_selector=silverman_rule_of_thumb)
    rec = {"theta": torch.randn(rec_cap, d, generator=g, device=dev) * 0.2
           + 0.4,
           "logq": torch.randn(rec_cap, generator=g, device=dev),
           "distance": torch.randn(rec_cap, generator=g, device=dev) * 20
           - 300.0,
           "valid": torch.arange(rec_cap, device=dev) < n_valid}
    logq_new = mvn_mixture_logpdf_plain(rec["theta"], params)
    v = torch.randn(n_cap, generator=g, device=dev) * 15 - 280.0

    def f(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    return dict(rec=rec, logq_new=logq_new, res_distance=v, k_mask=k_mask,
                w_norm=w / w.sum(), pdf_norm=f(-48.3), max_found=f(-60.0),
                daly_k=f(500.0), temp=f(800.0), acc_rate=f(0.05))


SCHEME_CASES = [
    (("acceptance_rate", 0.3),), (("acceptance_rate", 0.3),
                                  ("exp_decay_fixed_iter",)),
    (("poly_decay_fixed_iter", 3.0),), (("exp_decay_fixed_ratio", 0.5,
                                         1e-4, 0.5),),
    (("friel_pettitt",),), (("daly", 0.5, 0.1),), (("ess", 0.8),), (),
]


@pytest.mark.parametrize("n_cap,rec_cap,n_keep,n_valid", [
    (64, 512, 33, 301), (1024, 8192, 1000, 8192)])
@pytest.mark.parametrize("schemes", SCHEME_CASES)
@pytest.mark.parametrize("scaled", [None, (10.0, 0.5)])
def test_temperature_update_kernel(dev, n_cap, rec_cap, n_keep, n_valid,
                                   schemes, scaled):
    from pyabc_tpu_torch.epsilon.temperature import TempConfig
    from pyabc_tpu_torch.kernels import temperature_update
    from pyabc_tpu_torch.kernels.temperature_update import scheme_tables

    x = _temp_inputs(dev, n_cap, rec_cap, n_keep, n_valid)
    cfg = TempConfig(schemes=schemes, max_np=8, pdf_max=None, lin=False,
                     pdf_scaled=scaled, initial=("acceptance_rate", 0.3))
    kw = dict(x, tables=scheme_tables(schemes, dev), t_next=3, config=cfg)
    before = temperature_update.launches
    got = temperature_update.update(**kw)
    assert temperature_update.launches == before + 1
    cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
               else v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items() if k != "tables"}
    ref = temperature_update.update(tables=scheme_tables(schemes, "cpu"),
                                    **cpu)
    got, ref = [float(t) for t in got], [float(t) for t in ref]
    bisected = any(s[0] in ("acceptance_rate", "ess") for s in schemes)
    # a bisection step may flip where the rate lies within float32 rounding
    # of the target: rel 1e-4; the rest rel 1e-6
    assert got[0] == pytest.approx(ref[0], rel=1e-4 if bisected else 1e-6)
    assert got[1:] == pytest.approx(ref[1:], rel=1e-6)
    # the initial temperature from the reservoir as a calibration sample
    t0 = temperature_update.initial(
        res_distance=x["res_distance"], k_mask=x["k_mask"],
        tables=scheme_tables((cfg.initial,), dev), config=cfg)
    t0_ref = temperature_update.initial(
        res_distance=x["res_distance"].cpu(), k_mask=x["k_mask"].cpu(),
        tables=scheme_tables((cfg.initial,), "cpu"), config=cfg)
    assert float(t0[0]) == pytest.approx(float(t0_ref[0]), rel=1e-4)
    assert [float(t) for t in t0[1:]] == pytest.approx(
        [float(t) for t in t0_ref[1:]], rel=1e-6)


def test_noisy_runs_on_the_card(dev):
    """The noisy Gaussian anchor and SIR config 4 (pop 200) through the
    card's kernels, every plain version unused."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pyabc_tpu_torch.models import sir

    abc = pt.ABCSMC(sir.make_sir_model(), sir.default_prior(),
                    pt.IndependentNormalKernel(var=[100.0] * 15),
                    population_size=200, eps=pt.Temperature(),
                    acceptor=pt.StochasticAcceptor(), seed=0, device=dev)
    abc.MAX_ROUNDS = 1024
    abc.new("sqlite://", sir.observed_data(seed=11), store_sum_stats=False)
    reset_launch_counts()
    h = abc.run(max_nr_populations=8)
    counts = launch_counts()
    temps = [float(x) for x in h.get_all_populations()["epsilon"][1:]]
    assert h.n_populations == 8 and temps[-1] == 1.0
    assert all(b <= a for a, b in zip(temps, temps[1:]))
    for k in ("sir_simulate", "kernel_accept", "temperature_update",
              "compact_round", "mvn_mixture_logpdf", "propose", "mvn_fit",
              "normalize_quantile", "generation_health", "pack_fetch"):
        assert counts[k] > 0, k
    assert counts["pnorm_accept_weight"] == counts["lv_simulate"] == 0
    df, w = h.get_distribution()
    for k, true in sir.TRUE_PARS.items():
        assert abs(float(np.sum(df[k] * w)) - true) < 0.05


# --------------------------------------------- model selection (K > 1)
#: (lanes B, reservoir n_cap, models K, d_max): config 5's and a small odd one
MODEL_SHAPES = [(4096, 1024, 3, 2), (256, 64, 2, 1)]


def _model_priors(dev, K, d_max):
    from pyabc_tpu_torch.core.random_variables import stacked_arrays
    from pyabc_tpu_torch.models import model_selection as msel

    if d_max == 2:
        return stacked_arrays(msel.ode_family()[1][:K], dev)
    return stacked_arrays(
        [Distribution(a=RV("uniform", -1.0, 2.0))]
        + [Distribution(a=RV("norm", 0.1 * k, 1.0)) for k in range(1, K)],
        dev)


def _model_round(dev, B, n, K, d_max, seed=0):
    """Prior-mode proposals, a reservoir of their first n rows (an odd
    number kept), its K26 step and the per-model fits."""
    from pyabc_tpu_torch.kernels.model_step import model_step_plain
    from pyabc_tpu_torch.kernels.mvn_fit import mvn_fit_models_plain
    from pyabc_tpu_torch.kernels.propose import propose_models_plain
    from pyabc_tpu_torch.transition import ModelPerturbationKernel

    g = _gen(dev, seed)
    pri = _model_priors(dev, K, d_max)
    prior_p = torch.full((K,), 1.0 / K, device=dev)
    theta, _lp, _v, m = propose_models_plain(_stream(dev, philox.PRIOR), B,
                                             pri, prior_p)
    n_keep = n - n // 3 - 1
    k_mask = torch.arange(n, device=dev) < n_keep
    w = torch.softmax(torch.where(k_mask, torch.randn(n, generator=g,
                                                      device=dev),
                                  torch.full((n,), -math.inf, device=dev)),
                      0)
    res_theta, res_m = theta[:n].contiguous(), m[:n].contiguous()
    mpk = torch.as_tensor(ModelPerturbationKernel(K).device_params(),
                          device=dev)
    step = model_step_plain(res_m, w, k_mask,
                            torch.ones(K, dtype=torch.bool, device=dev), mpk)
    dims = [int(v) for v in pri["dims"].tolist()]
    statics = [dict(scaling=1.0, bandwidth_selector=silverman_rule_of_thumb)
               ] * K
    fits = mvn_fit_models_plain(res_theta, w, res_m, dims=dims,
                                statics=statics)
    return dict(pri=pri, prior_p=prior_p, theta=theta, m=m, k_mask=k_mask,
                w=w, res_theta=res_theta, res_m=res_m, mpk=mpk, step=step,
                dims=dims, statics=statics, fits=fits, n_keep=n_keep)


@pytest.mark.parametrize("B", [256, 4096])
@pytest.mark.parametrize("noise_sd", [0.0, 0.3])
def test_ode_family_kernel(dev, B, noise_sd):
    from pyabc_tpu_torch.kernels import (ode_family_simulate,
                                         ode_family_simulate_plain)
    from pyabc_tpu_torch.models import model_selection as msel

    x = _model_round(dev, B, 64, 3, 2)
    fam = msel.ode_family()[0][0].family
    kw = dict(n_obs=fam.n_obs, n_substeps=fam.n_substeps, dt=fam.dt,
              y0=msel.Y0, noise_sd=noise_sd,
              stream=_stream(dev, philox.SIM_NOISE))
    before = ode_family_simulate.launches
    got = ode_family_simulate(x["theta"], x["m"], **kw)
    assert ode_family_simulate.launches == before + 1
    ref = ode_family_simulate_plain(x["theta"], x["m"], **kw)
    # the RK4 rounds each operation once, as the plain version does;
    # Philox normals within 2e-6
    assert bool(((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
    with pytest.raises(ValueError, match="plain version"):
        ode_family_simulate(x["theta"], x["m"], noise=torch.zeros_like(ref),
                            **kw)


@pytest.mark.parametrize("B,n,K,d_max", MODEL_SHAPES)
@pytest.mark.parametrize("case", ["all", "dying", "never_fitted"])
def test_model_step_kernel(dev, B, n, K, d_max, case):
    from pyabc_tpu_torch.kernels import model_step, model_step_plain

    x = _model_round(dev, B, n, K, d_max)
    m, fitted = x["res_m"].clone(), torch.ones(K, dtype=torch.bool,
                                                device=dev)
    if case == "dying":
        m[m == 0] = 1
    elif case == "never_fitted":
        fitted[K - 1] = False
    args = (m, x["w"], x["k_mask"], fitted, x["mpk"])
    before = model_step.launches
    got = model_step(*args)
    assert model_step.launches == before + 1
    ref = model_step_plain(*args)
    assert torch.equal(got["counts"], ref["counts"])
    assert torch.equal(got["fitted"], ref["fitted"])
    for key in ("model_probs", "log_model_probs", "matrix",
                "log_model_factor"):
        # block sums against torch's, in another order
        torch.testing.assert_close(got[key], ref[key], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("B,n,K,d_max", MODEL_SHAPES)
def test_propose_models_kernel(dev, B, n, K, d_max):
    from pyabc_tpu_torch.kernels.propose import propose_models_plain

    x = _model_round(dev, B, n, K, d_max)
    for tag, args in ((philox.PRIOR, (x["prior_p"],)),
                      (philox.TRANSITION, (x["step"]["log_model_probs"],
                                           x["fits"], x["step"]["matrix"]))):
        stream = _stream(dev, tag)
        before = propose.launches
        th_k, lp_k, v_k, m_k = propose.models(stream, B, x["pri"], *args)
        assert propose.launches == before + 1
        th_p, lp_p, v_p, m_p = propose_models_plain(stream, B, x["pri"],
                                                    *args)
        # the model draws are inverse CDFs on the same uniforms
        assert int((m_k != m_p).sum()) <= 2
        same = m_k == m_p
        odd = ~same | (v_k != v_p) | (
            (th_k - th_p).abs() > 1e-5 + 1e-5 * th_p.abs()).any(dim=1)
        assert int(odd.sum()) <= max(4, B // 500)
        ok = ~odd & v_p
        assert float((lp_k - lp_p)[ok].abs().max()) <= 1e-5
        pad = torch.arange(d_max, device=dev)[None, :] >= \
            x["pri"]["dims"][m_k.long()][:, None]
        assert bool((th_k[pad] == 0).all())


@pytest.mark.parametrize("B,n,K,d_max", MODEL_SHAPES)
def test_mvn_logpdf_models_kernel(dev, B, n, K, d_max):
    from pyabc_tpu_torch.kernels.mvn_logpdf import (
        mvn_mixture_logpdf_models_plain)
    from pyabc_tpu_torch.kernels.propose import propose_models_plain

    x = _model_round(dev, B, n, K, d_max)
    q, _lp, _v, qm = propose_models_plain(
        _stream(dev, philox.TRANSITION), B, x["pri"],
        x["step"]["log_model_probs"], x["fits"], x["step"]["matrix"])
    before = mvn_mixture_logpdf.launches
    got = mvn_mixture_logpdf.models(q, qm, x["fits"])
    assert mvn_mixture_logpdf.launches == before + 1
    ref = mvn_mixture_logpdf_models_plain(q, qm, x["fits"])
    assert float((got - ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("B,n,K,d_max", MODEL_SHAPES)
def test_pnorm_accept_and_compact_with_models_kernel(dev, B, n, K, d_max):
    x = _model_round(dev, B, n, K, d_max)
    g = _gen(dev, 3)
    S = 12
    ss = torch.randn(B, S, generator=g, device=dev)
    valid = torch.rand(B, generator=g, device=dev) > 0.1
    logpri = torch.randn(B, generator=g, device=dev)
    logq = torch.randn(B, generator=g, device=dev)
    eps = torch.tensor(3.5, device=dev)
    kw = dict(p=2.0, logpri=logpri, logq=logq, m=x["m"],
              model_logits=torch.log(x["prior_p"]),
              log_model_factor=x["step"]["log_model_factor"])
    args = (ss, torch.zeros(S, device=dev), torch.ones(S, device=dev), eps,
            valid)
    d_k, a_k, lw_k = pnorm_accept_weight(*args, **kw)
    d_p, a_p, lw_p = pnorm_accept_weight_plain(*args, **kw)
    torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(lw_k, lw_p, rtol=1e-6, atol=1e-6)
    far = (d_p - eps).abs() > 1e-5
    assert torch.equal(a_k[far], a_p[far])

    def bufs():
        return ({"theta": torch.zeros(n, d_max, device=dev),
                 "sumstats": torch.zeros(n, S, device=dev),
                 "distance": torch.zeros(n, device=dev),
                 "log_weight": torch.full((n,), -math.inf, device=dev),
                 "slot": torch.full((n,), -1, dtype=torch.int32, device=dev),
                 "m": torch.zeros(n, dtype=torch.int32, device=dev)},
                torch.zeros(4, dtype=torch.int32, device=dev))

    (r_k, c_k), (r_p, c_p) = bufs(), bufs()
    inputs = (a_k, valid, x["theta"], ss, d_k, lw_k)
    before = compact_round.launches
    compact_round(*inputs, r_k, None, c_k, m=x["m"])
    assert compact_round.launches == before + 1
    compact_round_plain(*inputs, r_p, None, c_p, m=x["m"])
    assert torch.equal(c_k, c_p)
    for key in r_k:
        assert torch.equal(r_k[key], r_p[key]), key


@pytest.mark.parametrize("B,n,K,d_max", MODEL_SHAPES)
def test_mvn_fit_models_kernel(dev, B, n, K, d_max):
    from pyabc_tpu_torch.kernels.mvn_fit import mvn_fit_models_plain

    x = _model_round(dev, B, n, K, d_max)
    m = x["res_m"].clone()
    m[m == K - 1] = 0  # the last model has no weight: finite all the same
    before = mvn_fit.launches
    got = mvn_fit.models(x["res_theta"], x["w"], m, dims=x["dims"],
                         statics=x["statics"])
    assert mvn_fit.launches == before + 1
    ref = mvn_fit_models_plain(x["res_theta"], x["w"], m, dims=x["dims"],
                               statics=x["statics"])
    for key, v in got.items():
        assert bool(torch.isfinite(v).all()), key
        torch.testing.assert_close(v, ref[key], rtol=1e-4, atol=1e-5,
                                   msg=key)


@pytest.mark.parametrize("B,n,K,d_max", MODEL_SHAPES)
def test_pack_and_health_models_kernel(dev, B, n, K, d_max):
    from pyabc_tpu_torch.kernels.pack_fetch import pack_models_plain

    x = _model_round(dev, B, n, K, d_max)
    ms = [torch.roll(x["res_m"], g).contiguous() for g in range(8)]
    before = pack_fetch.launches
    got = pack_fetch.models(ms, n_keep=x["n_keep"])
    assert pack_fetch.launches == before + 1
    assert torch.equal(got, pack_models_plain(ms, n_keep=x["n_keep"]))
    f = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                               device=dev)
    for kind, word in (("ok", 0), ("psd", 128), ("unfitted", 0)):
        nxt = {k: v.clone() for k, v in x["fits"].items()}
        fitted_next = torch.ones(K, dtype=torch.bool, device=dev)
        if kind != "ok":
            nxt["chol"][K - 1, 0, 0] = math.nan
        if kind == "unfitted":
            fitted_next[K - 1] = False
        h = dict(theta=x["res_theta"], k_mask=x["k_mask"], w_norm=x["w"],
                 d_new=torch.rand(n, device=dev),
                 n_acc=x["k_mask"].sum(dtype=torch.int32),
                 n_target=x["n_keep"], acc_rate=f(0.3),
                 trans_params=x["fits"], trans_next=nxt,
                 fitted=torch.ones(K, dtype=torch.bool, device=dev),
                 fitted_next=fitted_next, eps_g=f(0.5), eps_next=f(0.4),
                 eps_prev=f(1.0),
                 stall_count=torch.tensor(0, dtype=torch.int32, device=dev),
                 ess_floor=0.0, acc_floor=0.0, stall_window=16,
                 stall_rtol=1e-6)
        w_k, ess_k, _e, _s = generation_health(**h)
        w_p, ess_p, _e2, _s2 = generation_health_plain(**h)
        assert int(w_k) == int(w_p) == word, kind
        torch.testing.assert_close(ess_k, ess_p, rtol=1e-5, atol=0)


def test_model_selection_runs_on_the_card(dev):
    """The ODE family (pop 300) through the card's kernels."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pyabc_tpu_torch.models import model_selection as msel

    models, priors, _ts = msel.ode_family()
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=300, seed=0, device=dev)
    abc.new("sqlite://", msel.observed_ode_family(seed=0),
            store_sum_stats=False)
    reset_launch_counts()
    h = abc.run(max_nr_populations=4)
    counts = launch_counts()
    assert h.n_populations == 4
    for k in ("propose", "mvn_mixture_logpdf", "ode_family_simulate",
              "pnorm_accept_weight", "compact_round", "normalize_quantile",
              "mvn_fit", "model_step", "pack_fetch", "generation_health"):
        assert counts[k] > 0, k
    p = h.get_model_probabilities(h.max_t)["p"]
    assert float(p.sum()) == pytest.approx(1.0)
    assert float(p.get(0, 0.0)) < 0.9


# ------------------------------------- tau leap and early reject (PR 5)
def _seg_round(dev, name, B, seed=0):
    """A prior round of a segmented model on the card: the model, theta,
    valid, the flat spec and x0 (a trajectory of the model)."""
    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.models import gillespie as g
    from pyabc_tpu_torch.models import sir

    if name == "bd":
        model, prior = g.make_birth_death_model(segments=10), \
            g.birth_death_prior()
        obs = g.observed_birth_death(segments=10)
    elif name == "lv":
        model, prior = g.make_stochastic_lv_model(segments=10), \
            g.stochastic_lv_prior()
        obs = g.observed_stochastic_lv(segments=10)
    else:
        model, prior = sir.make_network_sir_model(), sir.network_sir_prior()
        obs = sir.observed_network_sir()
    spec = SumStatSpec(obs)
    theta, _lp, valid = propose(_stream(dev, philox.PRIOR, seed=seed), B,
                                prior.arrays(dev))
    x0 = torch.as_tensor(spec.flatten_host(obs), dtype=torch.float32,
                         device=dev)
    return model, theta.contiguous(), valid, spec, x0


def _equal_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("B", [77, 4096])
@pytest.mark.parametrize("name,midpoint", [("bd", False), ("bd", True),
                                           ("lv", False)])
def test_tau_leap_kernel(dev, B, name, midpoint):
    """K19 against its plain version on the card: every count equal (the
    kernel rounds each operation on its own, as the plain version does),
    over the whole range and over a carried sub-range."""
    from dataclasses import replace

    from pyabc_tpu_torch.kernels import tau_leap, tau_leap_plain

    model, theta, _v, spec, _x0 = _seg_round(dev, name, B)
    kspec = replace(model.chain.kernel[1], midpoint=midpoint)
    st = _stream(dev, philox.SIM_NOISE)
    imap = model.index_map(spec, dev)
    before = tau_leap.launches
    got, _ = tau_leap(kspec, theta, st, colmap=imap, width=spec.total_size)
    assert tau_leap.launches == before + 1
    ref, _ = tau_leap_plain(kspec, theta, st, colmap=imap,
                            width=spec.total_size)
    assert _equal_nan(got, ref)
    head, x = tau_leap(kspec, theta, st, seg_to=4, return_state=True)
    tail, _ = tau_leap(kspec, theta, st, state=x, seg_from=4)
    whole, _ = tau_leap(kspec, theta, st)
    assert torch.equal(torch.cat([head, tail], dim=1), whole)


@pytest.mark.parametrize("B", [77, 4096])
@pytest.mark.parametrize("noise_sd", [0.0, 5.0])
def test_network_sir_kernel(dev, B, noise_sd):
    from dataclasses import replace

    from pyabc_tpu_torch.kernels import network_sir, network_sir_plain

    model, theta, _v, _spec, _x0 = _seg_round(dev, "net", B)
    kspec = replace(model.chain.kernel[1], noise_sd=noise_sd)
    st = _stream(dev, philox.SIM_NOISE)
    got, _ = network_sir(kspec, theta, st)
    ref, _ = network_sir_plain(kspec, theta, st)
    assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B", [256, 4096])
@pytest.mark.parametrize("name", ["bd", "lv", "net"])
def test_segment_round_kernel(dev, B, name):
    """K18 against its plain version on the card: the same kept slots,
    their statistics bit for bit, the same retired / stepped / resolved
    counts, and an occupancy in (0, 1]."""
    from pyabc_tpu_torch.kernels import segment_round, segment_round_plain

    model, theta, valid, spec, x0 = _seg_round(dev, name, B)
    st = _stream(dev, philox.SIM_NOISE)
    imap = model.index_map(spec, dev)
    w = torch.ones_like(x0)
    full, _ = model.chain.kernel[0](model.chain.kernel[1], theta, st,
                                    colmap=imap, width=spec.total_size)
    d = (full - x0).square().sum(1).sqrt()
    eps = torch.quantile(d[valid], 0.2)
    kw = dict(imap=imap, x0=x0, w=w, p=2.0, eps=eps,
              width=spec.total_size)
    c_got = torch.zeros(4, dtype=torch.int64, device=dev)
    c_ref = torch.zeros(4, dtype=torch.int64, device=dev)
    ss, keep = segment_round(model.segmented, theta, valid, st,
                             seg_ctr=c_got, **kw)
    ss_r, keep_r = segment_round_plain(model.segmented, theta, valid, st,
                                       seg_ctr=c_ref, **kw)
    assert torch.equal(keep, keep_r)
    assert torch.equal(ss[keep], ss_r[keep])
    assert torch.equal(c_got[:3], c_ref[:3]) and int(c_got[0]) > 0
    assert 0 < int(c_got[1]) <= int(c_got[3])


def test_early_reject_runs_on_the_card(dev):
    """Birth-death (segments 10, pop 2000) with early reject on and off on
    the card: bit-identical populations, K18 and K19 launched."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pyabc_tpu_torch.models import gillespie as g

    obs = g.observed_birth_death(segments=10)
    hs = []
    reset_launch_counts()
    for early in ("auto", False):
        abc = pt.ABCSMC(g.make_birth_death_model(segments=10),
                        g.birth_death_prior(), pt.PNormDistance(p=2),
                        population_size=2000, seed=3, early_reject=early,
                        fused_generations=2, device=dev)
        abc.new("sqlite://", obs, store_sum_stats=False)
        hs.append(abc.run(max_nr_populations=5))
    counts = launch_counts()
    assert counts["segment_round"] > 0 and counts["tau_leap"] > 0
    for t in range(5):
        a, wa = hs[0].get_distribution(m=0, t=t)
        b, wb = hs[1].get_distribution(m=0, t=t)
        assert np.array_equal(a.to_numpy(), b.to_numpy())
        assert np.array_equal(wa, wb)
    assert sum(hs[0].get_telemetry(t)["retired_early"]
               for t in range(5)) > 0


# ------------------------------- K22, K18's adaptive and K > 1 modes
def _fold_round(dev, B, S=20, n_seg=10, seed=0):
    g = _gen(dev, seed)
    imap = torch.randperm(S, generator=g, device=dev).reshape(
        n_seg, S // n_seg).to(torch.int32)
    from pyabc_tpu_torch.kernels.moments import seg_of_columns

    seg_of = torch.as_tensor(seg_of_columns(imap), device=dev)
    nseg = torch.randint(1, n_seg + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    valid = torch.rand(B, generator=g, device=dev) > 0.1
    ss = torch.randn(B, S, generator=g, device=dev) * 3 + 10
    ss[seg_of[None, :] >= nseg[:, None]] = math.nan
    x0 = torch.randn(S, generator=g, device=dev) + 10
    return ss, nseg, valid, seg_of, x0


@pytest.mark.parametrize("B", [77, 65536])
def test_moment_fold_kernel(dev, B):
    """K22's fold against its plain version over two rounds with the
    record window cut inside the second: counts and extrema equal, sums
    within 1e-5 relative (another order); the kernel's sums are the same
    from run to run."""
    from pyabc_tpu_torch.kernels import moment_fold, moment_fold_plain
    from pyabc_tpu_torch.ops.scale_reduce import init_moments

    outs = []
    for fn in (moment_fold, moment_fold, moment_fold_plain):
        mom = init_moments(20, dev)
        ctr = torch.zeros(4, dtype=torch.int32, device=dev)
        for r in range(2):
            ss, nseg, valid, seg_of, x0 = _fold_round(dev, B, seed=r)
            ctr[1] = r
            fn(mom, ss, nseg, valid, seg_of, x0, ctr,
               rec_cap=B + B // 2)
        outs.append(mom)
    got, again, ref = outs
    assert torch.equal(got, again)
    assert torch.equal(got[3:], ref[3:])
    assert within(got[:3], ref[:3], 1e-3, 1e-5)
    assert float(ref[3].max()) < 2 * B


@pytest.mark.parametrize("name", ["mean", "bias", "span",
                                  "standard_deviation",
                                  "root_mean_square_deviation",
                                  "mean_absolute_deviation_to_observation",
                                  "standard_deviation_to_observation"])
def test_moment_finish_kernel(dev, name):
    """K22's finish against its plain version: scale within 1e-6
    relative, weights and distances within 1e-5 (sums in another order)."""
    from pyabc_tpu_torch.kernels import moment_finish, moment_finish_plain
    from pyabc_tpu_torch.kernels.moments import moment_fold_plain
    from pyabc_tpu_torch.ops.scale_reduce import init_moments

    ss, nseg, valid, seg_of, x0 = _fold_round(dev, 4096)
    mom = init_moments(20, dev)
    moment_fold_plain(mom, ss, nseg, valid, seg_of, x0,
                      torch.zeros(4, dtype=torch.int32, device=dev),
                      rec_cap=10 ** 6)
    rows = torch.randn(1000, 20, generator=_gen(dev, 3), device=dev) + 10
    kw = dict(scale_name=name, max_weight_ratio=4.0, rows=rows, p=2.0)
    sc, w, d = moment_finish(mom, x0, **kw)
    sc_r, w_r, d_r = moment_finish_plain(mom, x0, **kw)
    assert within(sc, sc_r, 0.0, 1e-6)
    assert within(w, w_r, 0.0, 1e-5) and within(d, d_r, 0.0, 1e-5)


@pytest.mark.parametrize("name", ["bd", "lv", "net"])
def test_segment_round_adaptive_mode(dev, name):
    """K18's adaptive mode: nseg bit-equal to the plain version's, and the
    launch counted in the mode."""
    from pyabc_tpu_torch.kernels import segment_round, segment_round_plain

    model, theta, valid, spec, x0 = _seg_round(dev, name, 4096)
    st = _stream(dev, philox.SIM_NOISE)
    imap = model.index_map(spec, dev)
    w = torch.linspace(0.5, 1.5, spec.total_size, device=dev)
    full, _ = model.chain.kernel[0](model.chain.kernel[1], theta, st,
                                    colmap=imap, width=spec.total_size)
    d = (w * (full - x0)).square().sum(1).sqrt()
    kw = dict(imap=imap, x0=x0, w=w, p=2.0,
              eps=torch.quantile(d[valid], 0.3), width=spec.total_size,
              return_nseg=True)
    before = segment_round.mode_launches["adaptive"]
    ss, keep, nseg = segment_round(
        model.segmented, theta, valid, st,
        seg_ctr=torch.zeros(4, dtype=torch.int64, device=dev), **kw)
    assert segment_round.mode_launches["adaptive"] == before + 1
    _ss, keep_r, nseg_r = segment_round_plain(
        model.segmented, theta, valid, st,
        seg_ctr=torch.zeros(4, dtype=torch.int64, device=dev), **kw)
    assert torch.equal(nseg, nseg_r) and torch.equal(keep, keep_r)
    assert int((nseg < imap.shape[0]).sum()) > 0


def _family_round(dev, B, seed=0):
    g = _gen(dev, seed)
    theta = torch.stack([torch.rand(B, generator=g, device=dev) + 0.05,
                         torch.rand(B, generator=g, device=dev) * 9 + 1],
                        dim=1)
    m = torch.randint(0, 3, (B,), generator=g, device=dev,
                      dtype=torch.int32)
    theta[m == 0, 1] = 0.0
    return theta.contiguous(), m


@pytest.mark.parametrize("noise_sd", [0.0, 0.3])
def test_ode_family_segments_kernel(dev, noise_sd):
    """The segmented family's range kernel: chained segments bit-equal to
    the full trajectory, and against the plain version bit-equal without
    noise, within 1e-5 with it (the normals' libm)."""
    from dataclasses import replace

    from pyabc_tpu_torch.kernels import (ode_family_segments,
                                         ode_family_segments_plain)
    from pyabc_tpu_torch.models import model_selection as msel

    specs = [replace(s, noise_sd=noise_sd) for s in
             msel.ode_family(segments=4)[0][0].family.specs]
    theta, m = _family_round(dev, 4096)
    st = _stream(dev, philox.SIM_NOISE)
    full, y = ode_family_segments(specs, theta, st, m=m, return_state=True)
    head, y2 = ode_family_segments(specs, theta, st, m=m, seg_to=2,
                                   return_state=True)
    tail, y3 = ode_family_segments(specs, theta, st, m=m, state=y2,
                                   seg_from=2, return_state=True)
    assert torch.equal(torch.cat([head, tail], dim=1), full)
    assert torch.equal(y3, y)
    ref, _ = ode_family_segments_plain(specs, theta, st, m=m)
    if noise_sd == 0.0:
        assert torch.equal(full, ref)
    else:
        assert within(full, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("case", ["family", "family_noiseless", "bd_pair"])
def test_segment_round_models_mode(dev, case):
    """K18's K > 1 mode against its plain version: without noise the kept
    slots and their statistics bit for bit; the noisy family (its normals
    differ in the last bits) keeps the same slots but for a few at the
    threshold, their statistics within 1e-5. Its kept rows equal the
    classic range kernel's bit for bit."""
    from dataclasses import replace

    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.kernels import (ode_family_segments, segment_round,
                                         segment_round_plain, tau_leap)
    from pyabc_tpu_torch.models import gillespie as g
    from pyabc_tpu_torch.models import model_selection as msel

    B = 4096
    st = _stream(dev, philox.SIM_NOISE)
    if case == "bd_pair":
        models = [g.make_birth_death_model(segments=10),
                  g.make_birth_death_model(x0=25.0, segments=10)]
        spec = SumStatSpec(g.observed_birth_death(segments=10))
        theta, _lp, valid = propose(_stream(dev, philox.PRIOR), B,
                                    g.birth_death_prior().arrays(dev))
        m = torch.randint(0, 2, (B,), generator=_gen(dev), device=dev,
                          dtype=torch.int32)
        imap = models[0].index_map(spec, dev)
        full = torch.where((m == 0)[:, None], *[
            tau_leap(mo.chain.kernel[1], theta.contiguous(), st,
                     colmap=imap, width=20)[0] for mo in models])
        segs = [mo.segmented for mo in models]
    else:
        sd = 0.0 if case == "family_noiseless" else 0.3
        models = msel.ode_family(segments=4, noise_sd=sd)[0]
        spec = SumStatSpec({"y": np.zeros(12)})
        theta, m = _family_round(dev, B)
        valid = torch.rand(B, generator=_gen(dev, 2), device=dev) > 0.05
        imap = models[0].index_map(spec, dev)
        full = ode_family_segments(models[0].family.specs, theta, st,
                                   m=m)[0]
        segs = [mo.segmented for mo in models]
    x0 = full[0].clone()
    w = torch.ones_like(x0)
    d = (full - x0).square().sum(1).sqrt()
    kw = dict(imap=imap, x0=x0, w=w, p=2.0,
              eps=torch.quantile(d[valid], 0.3), width=spec.total_size,
              m=m, dims=[2] * len(segs))
    before = segment_round.mode_launches["k_gt_1"]
    ss, keep = segment_round(segs, theta, valid, st,
                             seg_ctr=torch.zeros(4, dtype=torch.int64,
                                                 device=dev), **kw)
    assert segment_round.mode_launches["k_gt_1"] == before + 1
    ss_r, keep_r = segment_round_plain(
        segs, theta, valid, st,
        seg_ctr=torch.zeros(4, dtype=torch.int64, device=dev), **kw)
    assert torch.equal(ss[keep], full[keep])
    assert int((~keep & valid).sum()) > 0
    if case == "family":
        both = keep & keep_r
        assert int((keep ^ keep_r).sum()) <= 4
        assert within(ss[both], ss_r[both], 1e-5, 1e-5)
    else:
        assert torch.equal(keep, keep_r)
        assert torch.equal(ss[keep], ss_r[keep])


def test_adaptive_and_model_early_reject_run_on_the_card(dev):
    """Birth-death under AdaptivePNormDistance(standard_deviation) and the
    segmented ODE family, early reject on and off on the card: K22 and
    K18's two modes launched, the weights refit every generation, the
    family's populations bit-identical on and off."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.distance.scale import standard_deviation
    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import gillespie as g
    from pyabc_tpu_torch.models import model_selection as msel

    reset_launch_counts()
    abc = pt.ABCSMC(g.make_birth_death_model(segments=10),
                    g.birth_death_prior(),
                    pt.AdaptivePNormDistance(
                        p=2, scale_function=standard_deviation),
                    population_size=2000, seed=3, fused_generations=2,
                    device=dev)
    abc.new("sqlite://", g.observed_birth_death(segments=10),
            store_sum_stats=False)
    h = abc.run(max_nr_populations=4)
    counts, modes = launch_counts(), mode_launch_counts()
    assert counts["moment_fold"] > 0 and counts["moment_finish"] > 0
    # K18 returns nseg exactly for the rounds the fold takes (those that
    # start below rec_cap)
    assert modes["segment_round:adaptive"] == counts["moment_fold"]
    assert 4 <= counts["moment_fold"] <= counts["segment_round"]
    w = abc.distance_function.weights
    assert all(not np.allclose(w[t], w[t - 1]) for t in range(1, 5))
    assert sum(h.get_telemetry(t)["retired_early"] for t in range(4)) > 0
    obs = msel.observed_ode_family(seed=0, segments=4)
    hs = []
    for early in ("auto", False):
        models, priors, _ts = msel.ode_family(segments=4)
        abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                        population_size=2000, seed=5, early_reject=early,
                        fused_generations=3, device=dev)
        abc.new("sqlite://", obs, store_sum_stats=False)
        hs.append(abc.run(max_nr_populations=3))
    assert mode_launch_counts()["segment_round:k_gt_1"] > 0
    assert launch_counts()["ode_family_segments"] > 0
    for t in range(3):
        assert np.array_equal(
            hs[0].get_model_probabilities(t)["p"].to_numpy(),
            hs[1].get_model_probabilities(t)["p"].to_numpy())
        a = hs[0].get_weighted_distances(t)["distance"].to_numpy()
        b = hs[1].get_weighted_distances(t)["distance"].to_numpy()
        assert np.array_equal(a, b)


# ---------------------------------------------- LocalTransition (K12-K15)
def _local_population(dev, n, d, n_valid, seed=0):
    g = _gen(dev, seed)
    X = torch.randn(n, d, generator=g, device=dev)
    w = torch.rand(n, generator=g, device=dev) + 0.1
    w[n_valid:] = 0.0
    return X.contiguous(), w.contiguous()


def within(a, b, atol, rtol):
    """|a - b| <= atol + rtol |b|, NaN where b is NaN."""
    if not torch.equal(a.isnan(), b.isnan()):
        return False
    fin = ~b.isnan()
    return bool(((a - b).abs()[fin] <= atol + rtol * b.abs()[fin]).all())


def _row_close(a, b, rtol):
    n = a.shape[0]
    scale = b.abs().reshape(n, -1).amax(dim=1)
    err = (a - b).abs().reshape(n, -1).amax(dim=1)
    return bool((err <= rtol * scale).all())


LOCAL_FIELDS = [  # (n_cap, d, dim, n_valid, fit keywords)
    (1024, 4, 4, 1000, dict(k_cap=256)),
    (16384, 4, 4, 16384, dict(k_cap=4096)),
    (64, 1, 1, 37, dict(k_cap=16)),
    (512, 3, 2, 500, dict(k_cap=128, selection="threshold")),
]


@pytest.mark.parametrize("case", range(len(LOCAL_FIELDS)))
def test_local_cov_kernel(dev, case):
    """K12 against its plain version: the same neighbours and counts bit
    for bit, covariances within 1e-4 of each row's largest entry."""
    from pyabc_tpu_torch.kernels import local_cov, local_cov_plain
    from pyabc_tpu_torch.transition import LocalTransition

    n, d, dim, n_valid, kw = LOCAL_FIELDS[case]
    X, w = _local_population(dev, n, d, n_valid, seed=case)
    cfg = LocalTransition.field_config(n, dim, scaling=1.0, device=dev, **kw)
    got = local_cov(X, w, want_idx=True, **cfg)
    ref = local_cov_plain(X, w, want_idx=True, **cfg)
    assert torch.equal(got["cnt"], ref["cnt"])
    assert torch.equal(got["idx"], ref["idx"])
    assert torch.equal(got["thetas"], ref["thetas"])
    assert _row_close(got["covs"], ref["covs"], 1e-4)
    assert within(got["weights"], ref["weights"], 0.0, 1e-6)
    assert within(got["cdf"], ref["cdf"], 1e-6, 1e-5)


@pytest.mark.parametrize("incremental", [False, True])
def test_local_factor_kernel(dev, incremental):
    """K13 against its plain version on the same field: n_changed equal,
    factors within float32 tolerance, a singular row on the ladder."""
    from pyabc_tpu_torch.kernels import local_cov, local_factor
    from pyabc_tpu_torch.kernels.local_factor import local_factor_plain
    from pyabc_tpu_torch.transition import LocalTransition

    n, d = 4096, 4
    X, w = _local_population(dev, n, d, n)
    cfg = LocalTransition.field_config(n, d, scaling=1.0, device=dev,
                                       k_cap=256)
    field = local_cov(X, w, **cfg)
    prev, _n = local_factor(field, None, dim=d, incremental=False)
    field2 = {**field, "covs": field["covs"].clone()}
    field2["covs"][: n // 10] *= 1.01  # a tenth of the rows change
    v = torch.tensor([1.0, 2.0, -1.0, 0.5], device=dev)
    field2["covs"][7] = v[:, None] * v[None, :]  # rank 1: on the ladder
    got, n_got = local_factor(field2, prev, dim=d, incremental=incremental)
    ref, n_ref = local_factor_plain(field2, prev, dim=d,
                                    incremental=incremental)
    assert int(n_got) == int(n_ref) == (n // 10 if incremental else n)
    assert within(got["chols"], ref["chols"], 1e-5, 1e-4)
    assert bool(torch.isfinite(got["chols"][7]).all())
    # the rank-1 row's precision is ~1e10 and conditioned as badly: its
    # logdet is held, its precision entries are not
    ok = torch.arange(n, device=dev) != 7
    assert _row_close(got["precs"][ok], ref["precs"][ok], 1e-3)
    assert within(got["logdets"], ref["logdets"], 1e-3, 1e-4)
    assert within(got["lconst"], ref["lconst"], 1e-3, 1e-4)
    flag = torch.zeros((), dtype=torch.int32, device=dev)
    field3 = local_cov(X, w, flag=flag, **cfg)
    kept, n0 = local_factor(field3, prev, dim=d, incremental=True, flag=flag)
    assert int(n0) == 0
    assert all(torch.equal(kept[k], prev[k]) for k in
               ("thetas", "weights", "cdf", "chols", "precs", "logdets",
                "lconst"))


def test_local_draw_and_density_kernels(dev):
    """K2's local mode and K14 against their plain versions."""
    from pyabc_tpu_torch.kernels import (local_logpdf, local_logpdf_plain,
                                         propose_local, propose_local_plain)
    from pyabc_tpu_torch.transition import LocalTransition

    n, d, B = 2048, 4, 8192
    X, w = _local_population(dev, n, d, n - 48)
    params = LocalTransition.device_fit(X, w, dim=d, scaling=1.0, k=128)
    prior = lv.default_prior().arrays(dev)
    st = _stream(dev, philox.TRANSITION)
    th, lp, v = propose_local(st, B, prior, params)
    th_r, lp_r, v_r = propose_local_plain(st, B, prior, params)
    assert torch.equal(v, v_r)
    assert within(th, th_r, 1e-5, 1e-5)
    got = local_logpdf(th, params)
    ref = local_logpdf_plain(th, params)
    assert within(got, ref, 1e-4, 1e-5)


def test_proposal_drift_kernel(dev):
    from pyabc_tpu_torch.kernels import proposal_drift, proposal_drift_plain

    X, w = _local_population(dev, 16384, 4, 16000)
    mask = w > 0
    for shift, fitted, gens in ((0.0, True, 0), (0.5, True, 3),
                                (0.0, False, 0)):
        kw = dict(dim=4, fitted=torch.tensor(fitted, device=dev),
                  gens_since=torch.tensor(gens, dtype=torch.int32,
                                          device=dev),
                  every=16, thr=0.3, min_count=5)
        got = proposal_drift(X, w, X * (1 + shift), w, mask, **kw)
        ref = proposal_drift_plain(X, w, X * (1 + shift), w, mask, **kw)
        assert within(got["drift"], ref["drift"], 1e-5, 1e-4)
        for k in ("refit", "flag", "gens_since", "fitted"):
            assert torch.equal(got[k], ref[k]), k


def test_local_transition_runs_on_the_card(dev):
    """The LV model under LocalTransition at pop 2000 with the cadence:
    K12-K15 and K2's local mode launched, the CPU's first epsilon equal."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.AdaptivePNormDistance(p=2), population_size=2000,
                    eps=pt.MedianEpsilon(), seed=101,
                    transitions=pt.LocalTransition(k_fraction=0.25),
                    refit_every=3, device=dev)
    abc.new("sqlite://", lv.observed_data(seed=123), store_sum_stats=False)
    h = abc.run(max_nr_populations=5)
    counts = launch_counts()
    assert h.n_populations == 5
    for k in ("local_cov", "local_factor", "propose_local", "local_logpdf",
              "proposal_drift"):
        assert counts[k] > 0, k
    assert [e[1] for e in abc.refit_events][:1] == [True]


# ------------------------- K21a / K21c by family, K18's stochastic mode
NOISE_KERNELS = {
    "independent_normal": lambda pt: pt.IndependentNormalKernel(var=4.0),
    "laplace": lambda pt: pt.IndependentLaplaceKernel(scale=2.0),
    "binomial": lambda pt: pt.BinomialKernel(p=0.9),
    "binomial-lin": lambda pt: pt.BinomialKernel(p=0.9,
                                                 ret_scale="SCALE_LIN"),
    "poisson": lambda pt: pt.PoissonKernel(),
    "poisson-lin": lambda pt: pt.PoissonKernel(ret_scale="SCALE_LIN"),
    "negbin_size": lambda pt: pt.NegativeBinomialKernel(p=0.5),
    "negbin_mean": lambda pt: pt.NegativeBinomialKernel(
        p=0.4, parameterization="mean"),
    "normal": lambda pt: pt.NormalKernel(cov=np.diag(np.linspace(
        1.0, 4.0, 20)) + 0.5),
    "normal-lin": lambda pt: pt.NormalKernel(
        cov=np.eye(20) * 2.0 + 0.5, ret_scale="SCALE_LIN"),
}


def _noise_round(dev, B, S=20, seed=0):
    g = _gen(dev, seed)
    x0 = torch.round(torch.rand(S, generator=g, device=dev) * 40)
    x0[0], x0[1] = 0.0, 2.5
    ss = x0 + (torch.randn(B, S, generator=g, device=dev) * 4).abs()
    ss[::13] = 0.0
    ss[1::13, :2] = torch.tensor([0.5, 2.5], device=dev)
    valid = torch.rand(B, generator=g, device=dev) > 0.1
    return ss.contiguous(), x0.contiguous(), valid


@pytest.mark.parametrize("B", [257, 65536])
@pytest.mark.parametrize("family", sorted(NOISE_KERNELS))
def test_noise_accept_kernel(dev, family, B):
    """K21a/K21c against the plain version: v within rel 1e-5 with the
    -inf/NaN masks equal, log weights within rel 1e-5, the accept flags
    equal away from log u."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec
    from pyabc_tpu_torch.kernels import kernel_accept, kernel_accept_plain
    from pyabc_tpu_torch.kernels.kernel_accept import accept_uniforms

    kern = NOISE_KERNELS[family](pt)
    kern.initialize(SumStatSpec({"x": np.zeros(20)}))
    ss, x0, valid = _noise_round(dev, B)
    lin = kern.ret_scale == "SCALE_LIN"
    stream = _stream(dev, philox.ACCEPT)
    g = _gen(dev, 5)
    args = (ss, x0, kern.device_params(dev), torch.tensor(4.0, device=dev),
            torch.tensor(-30.0, device=dev), valid)
    kw = dict(stream=stream, lin=lin, apply_iw=True,
              logpri=torch.randn(B, generator=g, device=dev),
              logq=torch.randn(B, generator=g, device=dev),
              family=kern.family)
    v, a, lw = kernel_accept(*args, **kw)
    v_r, a_r, lw_r = kernel_accept_plain(*args, **kw)
    assert torch.equal(v.isnan(), v_r.isnan())
    assert torch.equal(v.isneginf(), v_r.isneginf())
    f = torch.isfinite(v_r)
    torch.testing.assert_close(v[f], v_r[f], rtol=1e-5, atol=1e-5)
    fw = torch.isfinite(lw_r)
    assert torch.equal(fw, torch.isfinite(lw))
    torch.testing.assert_close(lw[fw], lw_r[fw], rtol=1e-5, atol=1e-5)
    ratio = ((torch.log(v_r.clamp_min(1e-30)) if lin else v_r) + 30.0) / 4
    logu = torch.log(accept_uniforms(stream, B))
    clear = ~((logu - ratio).abs() <= 1e-5 * (1 + ratio.abs()))
    assert torch.equal(a[clear], a_r[clear])


def test_normal_kernel_refuses_what_shared_memory_cannot_hold(dev):
    from pyabc_tpu_torch.kernels import kernel_accept
    from pyabc_tpu_torch.kernels.kernel_accept import MAX_NORMAL_S

    S = MAX_NORMAL_S + 1
    ss, x0 = torch.zeros(4, S, device=dev), torch.zeros(S, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        kernel_accept(ss, x0, torch.zeros(S * S + 2, device=dev),
                      torch.tensor(1.0, device=dev),
                      torch.tensor(0.0, device=dev),
                      torch.ones(4, dtype=torch.bool, device=dev),
                      stream=_stream(dev, philox.ACCEPT), lin=False,
                      apply_iw=True, family="normal")


@pytest.mark.parametrize("family", ["independent_normal", "laplace",
                                    "binomial", "poisson"])
def test_segment_round_stochastic_mode(dev, family):
    """K18's stochastic mode against its plain version on the card: the
    same kept slots, their statistics and counts bit for bit, retired > 0;
    at T = +inf only the invalid slots retire."""
    import dataclasses

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (kernel_accept, segment_round,
                                         segment_round_plain)

    model, theta, valid, spec, x0 = _seg_round(dev, "bd", 4096)
    kern = NOISE_KERNELS[family](pt)
    kern.initialize(spec)
    st = _stream(dev, philox.SIM_NOISE)
    acc = dataclasses.replace(st, tag=philox.ACCEPT)
    imap = model.index_map(spec, dev)
    params = kern.device_params(dev)
    full, _ = model.chain.kernel[0](model.chain.kernel[1], theta, st,
                                    colmap=imap, width=spec.total_size)
    v = kernel_accept(full, x0, params, torch.tensor(math.inf, device=dev),
                      torch.tensor(0.0, device=dev), valid, stream=acc,
                      lin=False, apply_iw=True, family=kern.family)[0]
    norm = torch.quantile(v[torch.isfinite(v)].double(), 0.9).float()
    for temp, retire in ((3.0, True), (math.inf, False)):
        kw = dict(imap=imap, x0=x0, w=params, p=2.0,
                  eps=torch.tensor(temp, device=dev),
                  width=spec.total_size, noise=kern.device_bound_fn(),
                  pdf_norm=norm, accept=acc)
        c_got = torch.zeros(4, dtype=torch.int64, device=dev)
        c_ref = torch.zeros(4, dtype=torch.int64, device=dev)
        ss, keep = segment_round(model.segmented, theta, valid, st,
                                 seg_ctr=c_got, **kw)
        ss_r, keep_r = segment_round_plain(model.segmented, theta, valid,
                                           st, seg_ctr=c_ref, **kw)
        assert torch.equal(keep, keep_r)
        assert torch.equal(ss[keep], ss_r[keep])
        assert torch.equal(c_got[:3], c_ref[:3])
        if retire:
            assert int((valid & ~keep).sum()) > 0
        else:
            assert torch.equal(keep, valid)


def test_noisy_early_reject_runs_on_the_card(dev):
    """Noisy birth-death (segments 10, pop 2000, IndependentNormalKernel,
    ScaledPDFNorm) with early reject on and off on the card: bit-identical
    populations and temperatures, K18's stochastic mode launched."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import gillespie as g

    obs = g.observed_birth_death(segments=10)
    hs = []
    reset_launch_counts()
    for early in ("auto", False):
        abc = pt.ABCSMC(
            g.make_birth_death_model(segments=10), g.birth_death_prior(),
            pt.IndependentNormalKernel(var=4.0), population_size=2000,
            eps=pt.Temperature(schemes=[pt.ExpDecayFixedIterScheme()],
                               initial_temperature=50.0),
            acceptor=pt.StochasticAcceptor(pdf_norm_method=pt.ScaledPDFNorm()),
            seed=3, early_reject=early, fused_generations=2, device=dev)
        abc.new("sqlite://", obs, store_sum_stats=False)
        hs.append(abc.run(max_nr_populations=5))
    assert mode_launch_counts()["segment_round:stochastic"] > 0
    assert np.array_equal(hs[0].get_all_populations()["epsilon"],
                          hs[1].get_all_populations()["epsilon"])
    for t in range(5):
        a, wa = hs[0].get_distribution(m=0, t=t)
        b, wb = hs[1].get_distribution(m=0, t=t)
        assert np.array_equal(a.to_numpy(), b.to_numpy())
        assert np.array_equal(wa, wb)
    assert sum(hs[0].get_telemetry(t)["retired_early"]
               for t in range(5)) > 0


# ------------------------------------------------------------------ K16
#: (K, n_cap, d, bootstraps, weighted rows): the LV adaptive leg's width,
#: config 5's (three models on d_max 2, model 1 dead) and a small odd one
K16_SHAPES = [(1, 16384, 4, 10, 16384), (3, 4096, 2, 10, 4096),
              (1, 100, 1, 3, 37)]


def _k16_inputs(dev, K, n_cap, d, n_live):
    g = _gen(dev, seed=K + n_cap)
    st = {"scaling": 1.0, "bandwidth_selector": silverman_rule_of_thumb}
    theta = (torch.randn(n_cap, d, generator=g, device=dev)
             * torch.linspace(0.5, 2.0, d, device=dev) + 1.0)
    w = torch.rand(n_cap, generator=g, device=dev) + 0.1
    w[n_live:] = 0.0
    w = w / w.sum()
    if K == 1:
        p = mvn_fit(theta, w, dim=d, **st)
        return ({k: p[k][None].contiguous()
                 for k in ("thetas", "weights", "cdf")}, [d], [st], None)
    dims = [1, 2, 2]
    m = (torch.arange(n_cap, device=dev) % K).to(torch.int32)
    m[m == 1] = 2
    theta[m == 0, 1:] = 0.0
    p = mvn_fit.models(theta, w, m, dims=dims, statics=[st] * K)
    probs = torch.stack([w[m == k].sum() for k in range(K)])
    return ({k: p[k] for k in ("thetas", "weights", "cdf")}, dims, [st] * K,
            probs)


@pytest.mark.parametrize("K,n_cap,d,nb,n_live", K16_SHAPES)
def test_bootstrap_cv_kernels(dev, K, n_cap, d, nb, n_live):
    """K16's four entries against their plain versions: the draw and the
    reset state bit-equal, the fit at K8's tolerances, each live model's
    CV within 1e-4 relative and the same from run to run, the bisect step
    bit-equal, and a whole bisection ending in the same state."""
    import importlib

    bc = importlib.import_module("pyabc_tpu_torch.kernels.bootstrap_cv")
    x, dims, statics, probs = _k16_inputs(dev, K, n_cap, d, n_live)
    alive = [k for k in range(K) if probs is None or float(probs[k]) > 0]
    dkw = dict(n_boot=nb, seed=5, generation=3, max_rounds=256, min_n=10,
               max_n=n_cap)
    before = dict(bc.bootstrap_cv.mode_launches)
    idx, state = bc.bootstrap_cv.draw(x["cdf"], **dkw)
    idx_p, state_p = bc.bootstrap_draw_plain(x["cdf"], **dkw)
    assert torch.equal(idx, idx_p) and torch.equal(state, state_p)
    fit = bc.bootstrap_cv.fit(x["thetas"], idx, state, dims=dims,
                              statics=statics)
    fit_p = bc.bootstrap_fit_plain(x["thetas"], idx, state, dims=dims,
                                   statics=statics)
    torch.testing.assert_close(fit["center"][alive], fit_p["center"][alive],
                               rtol=1e-5, atol=1e-7)
    for k in ("prec", "logdet", "quad"):
        torch.testing.assert_close(fit[k][alive], fit_p[k][alive],
                                   rtol=1e-4, atol=1e-5, msg=k)
    torch.testing.assert_close(
        fit["thetas_c"][alive], fit_p["thetas_c"][alive], rtol=1e-5,
        atol=1e-5 * float(fit_p["center"][alive].abs().max()))
    part = bc.bootstrap_cv.density(x["thetas"], x["weights"], fit_p, state)
    again = bc.bootstrap_cv.density(x["thetas"], x["weights"], fit_p, state)
    part_p = bc.bootstrap_density_plain(x["thetas"], x["weights"], fit_p,
                                        state)
    assert torch.equal(part, again)

    def cv_of(p):
        return p[..., 0].sum(1) / p[..., 1].sum(1).clamp_min(1e-38)

    torch.testing.assert_close(cv_of(part)[alive], cv_of(part_p)[alive],
                               rtol=1e-4, atol=0.0)
    target = 1.5 * float(cv_of(part_p)[alive].mean())
    s_k, s_p = state.clone(), state.clone()
    c_k = torch.zeros(bc.MAX_PROBES, device=dev)
    c_p = torch.zeros(bc.MAX_PROBES, device=dev)
    bc.bootstrap_cv.bisect(part, s_k, c_k, model_p=probs, target=target)
    bc.bootstrap_bisect_plain(part, s_p, c_p, model_p=probs, target=target)
    assert torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
    res = bc.required_nr(x["thetas"], x["weights"], x["cdf"], dims=dims,
                         statics=statics, model_p=probs, seed=5,
                         generation=3, max_rounds=256, target_cv=target,
                         min_n=10, max_n=n_cap, n_bootstrap=nb)
    idx2, st2 = bc.bootstrap_draw_plain(x["cdf"], **dkw)
    cvs2 = torch.zeros(bc.MAX_PROBES, device=dev)
    for _ in range(bc.n_probes(10, n_cap)):
        f2 = bc.bootstrap_fit_plain(x["thetas"], idx2, st2, dims=dims,
                                    statics=statics)
        p2 = bc.bootstrap_density_plain(x["thetas"], x["weights"], f2, st2)
        bc.bootstrap_bisect_plain(p2, st2, cvs2, model_p=probs,
                                  target=target)
    assert torch.equal(res["state"], st2)
    steps = int(st2[bc.STEP])
    torch.testing.assert_close(res["cvs"][:steps], cvs2[:steps], rtol=1e-4,
                               atol=1e-7)
    launched = {e: bc.bootstrap_cv.mode_launches[e] - before[e]
                for e in bc.BootstrapCV.ENTRIES}
    probes = bc.n_probes(10, n_cap)
    # the MVN path launches none of LocalTransition's entries
    assert launched == {"draw": 2, "fit": 1 + probes,
                        "density": 2 + probes, "bisect": 1 + probes,
                        "local_gather": 0, "local_density": 0}


def test_adaptive_lv_run_on_the_card(dev):
    """LV config 2 under AdaptivePopulationSize(start 1000, mean_cv 0.05,
    max 16384, 10 bootstraps), 4 generations on the card: the n trail
    stays in [10, 16384] and equals the stored counts, K16 ran in every
    generation but the last, and the host read the device only at the
    round counters and the chunk's fetch."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (mode_launch_counts,
                                         reset_launch_counts)

    aps = pt.AdaptivePopulationSize(start_nr_particles=1000, mean_cv=0.05,
                                    max_population_size=16384,
                                    n_bootstrap=10)
    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.AdaptivePNormDistance(p=2), population_size=aps,
                    eps=pt.MedianEpsilon(), seed=0, device=dev)
    abc.new("sqlite://", lv.observed_data(seed=0), store_sum_stats=False)
    reset_launch_counts()
    h = abc.run(max_nr_populations=4)
    tel = [h.get_telemetry(t) for t in range(4)]
    trail = [x["n_target"] for x in tel]
    counts = h.get_nr_particles_per_population()
    assert trail[0] == 1000 and all(10 <= n <= 16384 for n in trail)
    # K16's probes that did work ride the chunk's fetch into telemetry
    assert all(x["k16_probes"] >= 1 for x in tel[:3])
    assert "k16_probes" not in tel[3]
    assert [int(counts[t]) for t in range(4)] == trail
    assert aps.nr_particles == trail[-1]
    assert mode_launch_counts()["bootstrap_cv:draw"] == 3
    by = abc.sync_ledger.summary()["by_kind"]
    rounds = sum(g["rounds"] for g in abc.generation_log)
    assert set(by) == {"round_counters", "chunk_fetch"}
    assert by["chunk_fetch"] == 1 and 1 <= by["round_counters"] - rounds <= 2


# ------------------------------------------- K25 and K16's repair case
#: the sub-distances' p's of the K25 cells: 2 and 4, mixed
AGG_PS = [(2.0, math.inf), (1.0, 2.0, math.inf, 3.0)]


def _agg_params(dev, ps, S, seed=0):
    g = _gen(dev, seed)
    W = torch.rand(len(ps), generator=g, device=dev) + 0.5
    subs = torch.rand(len(ps), S, generator=g, device=dev) + 0.2
    return torch.cat([W, subs.reshape(-1)]).contiguous()


@pytest.mark.parametrize("B", [77, 65536])
@pytest.mark.parametrize("ps", AGG_PS)
def test_aggregate_accept_kernel(dev, B, ps):
    """K25's accept against its plain version: distances and the values
    mode within 1e-5 relative, flags equal away from eps, log weights
    equal (K5's epilogue), with use_complete_history's minimum."""
    from pyabc_tpu_torch.kernels import (aggregate_accept_weight,
                                         aggregate_accept_weight_plain)
    from pyabc_tpu_torch.kernels.aggregate import sub_distances_plain

    S = 40
    g = _gen(dev, 1)
    ss = torch.randn(B, S, generator=g, device=dev) * 3.0
    ss[B // 2] = float("nan")
    x0 = torch.randn(S, generator=g, device=dev)
    params = _agg_params(dev, ps, S)
    valid = torch.rand(B, generator=g, device=dev) > 0.1
    logpri = torch.randn(B, generator=g, device=dev) - 3.0
    logq = torch.randn(B, generator=g, device=dev) - 2.0
    d_all = aggregate_accept_weight_plain(
        ss, x0, params, torch.tensor(math.inf, device=dev), valid, ps=ps)[0]
    fin = d_all[torch.isfinite(d_all)]
    eps, hist = torch.quantile(fin, 0.6), torch.quantile(fin, 0.4)
    kw = dict(ps=ps, hist_min=hist, logpri=logpri, logq=logq)
    d, a, lw = aggregate_accept_weight(ss, x0, params, eps, valid, **kw)
    d_r, a_r, lw_r = aggregate_accept_weight_plain(ss, x0, params, eps,
                                                   valid, **kw)
    torch.testing.assert_close(d, d_r, rtol=1e-5, atol=0.0, equal_nan=True)
    far = (d_r - hist).abs() > 1e-5 * hist
    assert torch.equal(a[far], a_r[far])
    assert torch.equal(lw, lw_r)
    vals = aggregate_accept_weight.values(ss, x0, params, ps=ps)
    torch.testing.assert_close(vals, sub_distances_plain(ss, x0, params, ps),
                               rtol=1e-5, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("name", ["span", "standard_deviation",
                                  "median_absolute_deviation"])
def test_aggregate_refit_kernel(dev, name):
    """K25's refit against its plain version over a ring with unwritten
    rows: scales, W and the reservoir's distances within 1e-5 relative;
    the scale of span and of the median bit-equal to the plain scale of
    the kernel's own values."""
    from pyabc_tpu_torch.kernels import (aggregate_accept_weight,
                                         aggregate_refit,
                                         aggregate_refit_plain)
    from pyabc_tpu_torch.kernels.scale_reduce import SCALES_PLAIN

    S, n, ps = 40, 8192, (2.0, 1.0, math.inf)
    g = _gen(dev, 2)
    ring = torch.randn(n, S, generator=g, device=dev) * 2.0
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[-1000:] = False
    ring[-1000:] = 1e6
    x0 = torch.randn(S, generator=g, device=dev)
    rows = torch.randn(1024, S, generator=g, device=dev)
    params = _agg_params(dev, ps, S, seed=3)
    kw = dict(ps=ps, factors=(1.0, 2.5, 0.5), scale_name=name, rows=rows)
    sc, new, d = aggregate_refit(ring, valid, x0, params, **kw)
    sc_r, new_r, d_r = aggregate_refit_plain(ring, valid, x0, params, **kw)
    torch.testing.assert_close(sc, sc_r, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(new, new_r, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(d, d_r, rtol=1e-5, atol=0.0)
    assert torch.equal(new[3:], params[3:])
    if name != "standard_deviation":
        vals = aggregate_accept_weight.values(ring, x0, params, ps=ps)
        assert torch.equal(sc, SCALES_PLAIN[name](
            vals, valid, torch.zeros(3, device=dev)))


@pytest.mark.parametrize("B", [256, 4096])
def test_segment_round_aggregate_mode(dev, B):
    """K18's aggregate mode against its plain version (birth-death, the
    pair of tests/test_segment.py:114): the same kept slots, their
    statistics bit for bit, the same counters."""
    from pyabc_tpu_torch.kernels import (aggregate_accept_weight_plain,
                                         segment_round, segment_round_plain)

    model, theta, valid, spec, x0 = _seg_round(dev, "bd", B)
    st = _stream(dev, philox.SIM_NOISE)
    imap = model.index_map(spec, dev)
    S = spec.total_size
    params = torch.cat([torch.tensor([0.7, 1.3], device=dev),
                        torch.ones(2 * S, device=dev)])
    ps = (2.0, math.inf)
    full, _ = model.chain.kernel[0](model.chain.kernel[1], theta, st,
                                    colmap=imap, width=S)
    d = aggregate_accept_weight_plain(
        full, x0, params, torch.tensor(math.inf, device=dev), valid,
        ps=ps)[0]
    eps = torch.quantile(d[valid], 0.2)
    kw = dict(imap=imap, x0=x0, w=params, p=2.0, eps=eps, width=S, agg=ps)
    c_got = torch.zeros(4, dtype=torch.int64, device=dev)
    c_ref = torch.zeros(4, dtype=torch.int64, device=dev)
    ss, keep = segment_round(model.segmented, theta, valid, st,
                             seg_ctr=c_got, **kw)
    ss_r, keep_r = segment_round_plain(model.segmented, theta, valid, st,
                                       seg_ctr=c_ref, **kw)
    assert torch.equal(keep, keep_r)
    assert torch.equal(ss[keep], ss_r[keep])
    assert torch.equal(c_got[:3], c_ref[:3]) and int(c_got[0]) > 0
    retired = valid & ~keep
    assert not bool((d[retired] <= eps).any())


def test_aggregate_runs_on_the_card(dev):
    """LV under the adaptive aggregate and under an aggregated schedule
    (pop 1000, 3 generations), and birth-death under the fixed pair with
    early reject on and off: K25's accept and refit and K18's aggregate
    mode launched, K5 and K9 not, populations bit-identical on and off,
    one counter read a round and one fetch a chunk."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import gillespie as gl

    subs = [pt.PNormDistance(p=2, weights={"pred": 1, "prey": 0}),
            pt.PNormDistance(p=1, weights={"pred": 0, "prey": 1})]
    for dist in (pt.AdaptiveAggregatedDistance(subs),
                 pt.AggregatedDistance(
                     [pt.PNormDistance(p=2, weights={0: {"pred": 1,
                                                         "prey": 0},
                                                     2: {"pred": 2,
                                                         "prey": 0}}),
                      pt.PNormDistance(p=1)], weights={0: [1, 1],
                                                       1: [4, 0.1]})):
        abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(), dist,
                        population_size=1000, eps=pt.MedianEpsilon(),
                        seed=0, device=dev)
        abc.new("sqlite://", lv.observed_data(seed=0),
                store_sum_stats=False)
        reset_launch_counts()
        h = abc.run(max_nr_populations=3)
        counts = launch_counts()
        assert h.max_t == 2
        assert counts["aggregate_accept_weight"] > 0
        assert counts["pnorm_accept_weight"] == counts["scale_reduce"] == 0
        assert (counts["aggregate_refit"] > 0) == dist.adaptive
        by = abc.sync_ledger.summary()["by_kind"]
        assert set(by) == {"round_counters", "chunk_fetch"}
        assert all(g["syncs"] == g["rounds"] for g in abc.generation_log)
    obs = gl.observed_birth_death(segments=10)
    pops = []
    for early in ("auto", False):
        abc = pt.ABCSMC(gl.make_birth_death_model(segments=10),
                        gl.birth_death_prior(),
                        pt.AggregatedDistance([pt.PNormDistance(p=2),
                                               pt.PNormDistance(p=np.inf)],
                                              weights=[0.7, 1.3]),
                        population_size=2000, eps=pt.MedianEpsilon(),
                        seed=7, early_reject=early, fused_generations=2,
                        device=dev)
        abc.new("sqlite://", obs, store_sum_stats=False)
        reset_launch_counts()
        h = abc.run(max_nr_populations=4)
        modes = mode_launch_counts()
        assert (modes["segment_round:aggregate"] > 0) == (early == "auto")
        pops.append([h.get_distribution(0, t)[0].to_numpy()
                     for t in range(4)])
    assert all(np.array_equal(a, b) for a, b in zip(*pops))


def _k16_repair_inputs(dev):
    """tests/test_torch_population.py's model-weighted case (n_cap 128, K
    3, dims 1, 2, 2, model 1 dead) with numpy ancestors, model 2's
    bootstrap 3 starting at rows 71, 22, 71 (rank 1 at n = 3)."""
    n_cap, K, nb = 128, 3, 5
    rng = np.random.default_rng(21)
    th = (rng.normal(size=(n_cap, 2)) * np.linspace(0.5, 2.0, 2)
          + 1).astype(np.float32)
    w = (rng.random(n_cap) + 0.1).astype(np.float32)
    w = w / w.sum()
    m = (np.arange(n_cap) % K).astype(np.int32)
    m[m == 1] = 2
    th[m == 0, 1] = 0.0
    st = {"scaling": 1.0, "bandwidth_selector": silverman_rule_of_thumb}
    fit = mvn_fit.models(torch.from_numpy(th).to(dev),
                         torch.from_numpy(w).to(dev),
                         torch.from_numpy(m).to(dev), dims=[1, 2, 2],
                         statics=[st] * K)
    draw = np.random.default_rng(5)
    idx = np.zeros((K, nb, n_cap), np.int32)
    for k in (0, 2):
        live = np.flatnonzero(m == k)
        idx[k] = draw.choice(live, size=(nb, n_cap),
                             p=w[live] / w[live].sum())
    idx[2, 3, :3] = (71, 22, 71)
    return fit, torch.from_numpy(idx).to(dev), [st] * K


def test_k16_rank_deficient_bootstrap(dev):
    """The K16 repair case: model 2's rank-1 bootstrap at n = 3. The
    kernels' fit and density give each live model's CV finite and within
    1e-4 relative of the plain versions'."""
    import importlib

    bc = importlib.import_module("pyabc_tpu_torch.kernels.bootstrap_cv")
    fit0, idx, statics = _k16_repair_inputs(dev)
    th, w = fit0["thetas"], fit0["weights"]
    state = torch.tensor([10, 128, 3, 0, 0], dtype=torch.int32, device=dev)
    fit = bc.bootstrap_cv.fit(th, idx, state, dims=[1, 2, 2],
                              statics=statics)
    fit_p = bc.bootstrap_fit_plain(th, idx, state, dims=[1, 2, 2],
                                   statics=statics)
    assert bool(torch.isfinite(fit_p["prec"][2, 3]).all())

    def cv_of(p):
        return (p[..., 0].sum(1) / p[..., 1].sum(1).clamp_min(1e-38))[[0, 2]]

    cv = cv_of(bc.bootstrap_cv.density(th, w, fit, state))
    cv_p = cv_of(bc.bootstrap_density_plain(th, w, fit_p, state))
    assert bool(torch.isfinite(cv).all()) and float(cv_p[1]) > 0
    torch.testing.assert_close(cv, cv_p, rtol=1e-4, atol=0.0)


def _learned_fit_inputs(dev, n_cap, S, C, n_keep, seed=0):
    """Reservoir-like rows for K23's fit: S statistics with counts in the
    thousands (a network SIR's scale), C' thetas, weights, the counters."""
    g = _gen(dev, seed)
    theta = torch.rand(n_cap, C, generator=g, device=dev)
    mix = torch.randn(C, S, generator=g, device=dev)
    x = (theta @ mix * 300.0 + 2000.0
         + 30.0 * torch.randn(n_cap, S, generator=g, device=dev))
    w = torch.rand(n_cap, generator=g, device=dev) + 0.1
    w[n_keep:] = 0.0
    ctr = torch.zeros(5, dtype=torch.int32, device=dev)
    ctr[0], ctr[4] = n_keep + 17, n_keep
    old = {"W": torch.zeros(S, C, device=dev),
           "b": torch.zeros(C, device=dev),
           "mu": torch.zeros(S, device=dev),
           "sd": torch.ones(S, device=dev)}
    return x.contiguous(), theta.contiguous(), w, ctr, old


@pytest.mark.parametrize("n_cap,S,C,n_keep", [(300, 6, 2, 211),
                                              (16384, 128, 2, 9731),
                                              (4096, 128, 8, 3001)])
def test_ridge_fit_kernel(dev, n_cap, S, C, n_keep):
    """K23's fit against its plain version: W, b, mu, sd within 1e-4
    relative (both solve in float64), the flags equal, the same from run
    to run; a poisoned row keeps the old parameters."""
    from pyabc_tpu_torch.kernels import ridge_fit, ridge_fit_plain

    x, y, w, ctr, old = _learned_fit_inputs(dev, n_cap, S, C, n_keep)
    before = ridge_fit.launches
    got, flags = ridge_fit(x, y, w, ctr, old, alpha=1.0, need=S + 2)
    assert ridge_fit.launches == before + 1
    ref, rflags = ridge_fit_plain(x, y, w, ctr, old, alpha=1.0, need=S + 2)
    assert flags.tolist() == rflags.tolist() == [1, 1]
    for k in ("W", "b", "mu", "sd"):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-4, atol=1e-5)
    again, _f = ridge_fit(x, y, w, ctr, old, alpha=1.0, need=S + 2)
    assert all(torch.equal(got[k], again[k]) for k in got)
    x[3, 1] = float("nan")
    kept, kflags = ridge_fit(x, y, w, ctr, old, alpha=1.0, need=S + 2)
    assert kflags.tolist() == [0, 1]
    assert all(torch.equal(kept[k], old[k]) for k in old)
    skip, sflags = ridge_fit(x, y, w, ctr, old, alpha=1.0, need=n_keep + 1)
    assert sflags.tolist() == [1, 0]
    assert all(torch.equal(skip[k], old[k]) for k in old)


@pytest.mark.parametrize("B,S,C", [(257, 7, 3), (65536, 128, 2)])
@pytest.mark.parametrize("p", [1.0, 2.0, math.inf])
def test_linear_accept_kernel(dev, B, S, C, p):
    """K23's transform and accept against the plain versions: rows and
    distances within 1e-5 of the feature scale, flags equal away from
    eps, log weights equal; the values mode bit-equal to the accept's."""
    from pyabc_tpu_torch.kernels import (linear_accept, linear_accept_plain,
                                         transform_rows,
                                         transform_rows_plain)

    g = _gen(dev, B)
    params = {"W": torch.randn(S, C, generator=g, device=dev) * 0.05,
              "b": torch.randn(C, generator=g, device=dev),
              "mu": torch.full((S,), 2000.0, device=dev),
              "sd": torch.rand(S, generator=g, device=dev) * 300 + 100}
    x0 = 2000.0 + 300.0 * torch.randn(S, generator=g, device=dev)
    ss = (x0 + 300.0 * torch.randn(B, S, generator=g, device=dev))
    w = torch.rand(C, generator=g, device=dev) + 0.5
    valid = torch.rand(B, generator=g, device=dev) > 0.1
    logpri = torch.randn(B, generator=g, device=dev)
    logq = torch.randn(B, generator=g, device=dev)
    rows = transform_rows(ss, params)
    rows_r = transform_rows_plain(ss, params)
    scale = float(rows_r.abs().max())
    torch.testing.assert_close(rows, rows_r, rtol=1e-5, atol=1e-5 * scale)
    d_r = linear_accept_plain(ss, x0, params, w,
                              torch.tensor(math.inf, device=dev), valid,
                              p=p)[0]
    eps = torch.quantile(d_r, 0.4)
    got = linear_accept(ss, x0, params, w, eps, valid, p=p, logpri=logpri,
                        logq=logq)
    ref = linear_accept_plain(ss, x0, params, w, eps, valid, p=p,
                              logpri=logpri, logq=logq)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5,
                               atol=1e-5 * scale)
    far = (ref[0] - eps).abs() > 1e-4 * scale
    assert torch.equal(got[1][far], ref[1][far])
    assert torch.equal(got[2], ref[2])
    assert torch.equal(linear_accept.values(ss, x0, params, w, p=p), got[0])


@pytest.mark.parametrize("case", ["network map", "one row a segment"])
def test_linear_bound_kernel(dev, case):
    """K18's transformed operands against the plain version (float64
    eigh): At bit-equal, null counts equal, projectors within 1e-5."""
    from pyabc_tpu_torch.kernels import linear_bound, linear_bound_plain

    g = _gen(dev, 3)
    n_seg, seg, C = (4, 32, 2) if case == "network map" else (6, 1, 3)
    S = n_seg * seg
    imap = torch.randperm(S, generator=g, device=dev).view(
        n_seg, seg).to(torch.int32).contiguous()
    params = {"W": torch.randn(S, C, generator=g, device=dev),
              "sd": torch.rand(S, generator=g, device=dev) + 0.5}
    w = torch.rand(C, generator=g, device=dev) + 0.5
    got = linear_bound(w, params, imap)
    ref = linear_bound_plain(w, params, imap)
    assert torch.equal(got["At"], ref["At"])
    counts = torch.diagonal(got["proj"], dim1=1, dim2=2).sum(1).round()
    rcounts = torch.diagonal(ref["proj"], dim1=1, dim2=2).sum(1).round()
    assert torch.equal(counts, rcounts)
    torch.testing.assert_close(got["proj"], ref["proj"], rtol=0, atol=1e-5)
    if case == "one row a segment":
        assert int(counts[-2]) == C - 1 and int(counts[-1]) == C


@pytest.mark.parametrize("B", [256, 65536])
@pytest.mark.parametrize("name", ["sir", "bd"])
def test_segment_round_linear_mode(dev, name, B):
    """K18's transformed mode against its plain version: the same kept
    slots, their statistics bit for bit, the same counters, some slots
    accepted. On the network SIR's round (C' 2, 32 values a segment)
    nothing can retire; on config 3's birth-death round (10 segments of 2
    values) under a C' 8 transform the last three segments' rows leave a
    null space, and valid slots retire."""
    from pyabc_tpu_torch.kernels import (linear_accept_plain, linear_bound,
                                         segment_round, segment_round_plain)

    model, theta, valid, spec, x0 = _seg_round(dev, name, B)
    st = _stream(dev, philox.SIM_NOISE)
    imap = model.index_map(spec, dev)
    S = spec.total_size
    g = _gen(dev, 5)
    if name == "sir":
        C = 2
        params = {"W": torch.randn(S, C, generator=g, device=dev) * 1e-3,
                  "b": torch.zeros(C, device=dev), "mu": x0.clone(),
                  "sd": torch.full((S,), 50.0, device=dev)}
    else:
        C = 8
        params = {"W": torch.randn(S, C, generator=g, device=dev),
                  "b": torch.zeros(C, device=dev), "mu": x0.clone(),
                  "sd": x0.abs().clamp(min=1.0)}
    w = torch.ones(C, device=dev)
    bp = linear_bound(w, params, imap)
    kw = dict(imap=imap, x0=x0, w=w, p=2.0, width=S, lin=bp)
    inf = torch.tensor(math.inf, device=dev)
    full, _k = segment_round_plain(
        model.segmented, theta, valid, st, eps=inf,
        seg_ctr=torch.zeros(4, dtype=torch.int64, device=dev), **kw)
    d = linear_accept_plain(full, x0, params, w, inf, valid, p=2.0)[0]
    eps = torch.quantile(d[valid], 0.3)
    c_got = torch.zeros(4, dtype=torch.int64, device=dev)
    c_ref = torch.zeros(4, dtype=torch.int64, device=dev)
    ss, keep = segment_round(model.segmented, theta, valid, st, eps=eps,
                             seg_ctr=c_got, **kw)
    ss_r, keep_r = segment_round_plain(model.segmented, theta, valid, st,
                                       eps=eps, seg_ctr=c_ref, **kw)
    assert torch.equal(keep, keep_r)
    assert torch.equal(ss[keep], ss_r[keep])
    assert torch.equal(c_got[:3], c_ref[:3])
    assert not bool((d[valid & ~keep] <= eps).any())
    assert bool((keep & (d <= eps)).any())
    if name == "bd":
        assert int(c_got[0]) > int((~valid).sum())


def test_learned_statistics_run_on_the_card(dev):
    """The network SIR (8 patches, the kernel's, x 8 observations: S 64)
    under the linear learned statistic,
    early reject on and off, and the adaptive form: K23's fit, transform
    and accept and K18's transformed mode launched, populations
    bit-identical on and off, the fetch C' wide after generation 0, one
    counter read a round and one fetch a chunk (and the seed's read
    under the adaptive distance)."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import sir

    shape = dict(n_patches=8, n_obs=8)
    pops = []
    for early in ("auto", False):
        abc = pt.ABCSMC(
            sir.make_network_sir_model(**shape), sir.network_sir_prior(),
            pt.PNormDistance(p=2, sumstat=pt.PredictorSumstat(
                pt.LinearPredictor(alpha=1.0))), population_size=1000,
            eps=pt.MedianEpsilon(), seed=11, fused_generations=2,
            early_reject=early, device=dev)
        abc.new("sqlite://", sir.observed_network_sir(**shape))
        reset_launch_counts()
        h = abc.run(max_nr_populations=5)
        counts, modes = launch_counts(), mode_launch_counts()
        assert h.n_populations == 5
        assert counts["ridge_fit"] == 2 and counts["linear_accept"] > 0
        assert (modes["segment_round:linear"] > 0) == (early == "auto")
        assert (counts["linear_bound"] > 0) == (early == "auto")
        assert h.get_weighted_sum_stats(1)[1].shape[1] == 2
        by = abc.sync_ledger.summary()["by_kind"]
        assert set(by) == {"round_counters", "chunk_fetch"}
        pops.append([h.get_distribution(0, t)[0].to_numpy()
                     for t in range(5)])
    assert all(np.array_equal(a, b) for a, b in zip(*pops))
    abc = pt.ABCSMC(
        sir.make_network_sir_model(**shape), sir.network_sir_prior(),
        pt.AdaptivePNormDistance(p=2, sumstat=pt.PredictorSumstat(
            pt.LinearPredictor(alpha=1.0))), population_size=1000,
        eps=pt.MedianEpsilon(), seed=11, fused_generations=2, device=dev)
    abc.new("sqlite://", sir.observed_network_sir(**shape))
    h = abc.run(max_nr_populations=4)
    assert h.n_populations == 4
    assert abc.distance_function.weights[3].shape == (2,)
    assert abc.sync_ledger.summary()["by_kind"]["sumstat_seed"] == 1


def _mlp_params(dev, sizes, seed=0):
    """A seeded MLP transform (MLPPredictor's init) as the kernels take
    it: the layers views of one packed buffer, mu 0, sd 1, ymu 0, ysd 1."""
    import pyabc_tpu_torch as pt

    return pt.MLPPredictor(seed=seed).init_params(sizes, dev)


def _param_leaves(params):
    from pyabc_tpu_torch.ops.fit import param_leaves

    return param_leaves(params)


@pytest.mark.parametrize("n_cap,sizes,n_keep", [
    (300, (6, 8, 8, 2), 211), (16384, (128, 64, 64, 2), 9731),
    (4096, (128, 40, 24, 12, 8), 3001)])
def test_mlp_fit_kernel(dev, n_cap, sizes, n_keep):
    """K23's MLP fit against its plain version: the gradient within 1e-4
    relative (1e-5 of its scale absolute), the loss after 100 steps within
    1e-3 relative, mu, sd, ymu, ysd within 1e-5, the flags equal, the same
    bits run to run; a poisoned row and a fit below need keep the old
    parameters."""
    from pyabc_tpu_torch.kernels import mlp_fit, mlp_fit_plain
    from pyabc_tpu_torch.kernels.mlp_fit import mlp_gradient_plain
    from pyabc_tpu_torch.ops.fit import (MLP_KEYS, fit_decision,
                                         mlp_fit_rows, mlp_loss_grad)

    S, C = sizes[0], sizes[-1]
    x, theta, w, ctr, _old = _learned_fit_inputs(dev, n_cap, S, C, n_keep)
    y = torch.sin(3.0 * theta).contiguous()
    old = _mlp_params(dev, sizes)
    kw = dict(lr=1e-3, n_steps=100, need=S + 2)
    g_k = mlp_fit.gradient(x, y, w, ctr, old, need=S + 2)
    g_p = mlp_gradient_plain(x, y, w, ctr, old, need=S + 2)
    torch.testing.assert_close(g_k, g_p, rtol=1e-4,
                               atol=1e-5 * float(g_p.abs().max()))
    before = mlp_fit.launches
    got, flags = mlp_fit(x, y, w, ctr, old, **kw)
    assert mlp_fit.launches == before + 1
    ref, rflags = mlp_fit_plain(x, y, w, ctr, old, **kw)
    assert flags.tolist() == rflags.tolist() == [1, 1]
    for k in MLP_KEYS:
        torch.testing.assert_close(got[k], ref[k], rtol=1e-5, atol=1e-6)
    mask, _fit = fit_decision(ctr, n_cap, S + 2)
    rows = mlp_fit_rows(old, x, y, w, mask)[:4]
    loss_k = float(mlp_loss_grad(got["layers"], *rows)[0])
    loss_p = float(mlp_loss_grad(ref["layers"], *rows)[0])
    assert loss_k < float(mlp_loss_grad(old["layers"], *rows)[0])
    assert abs(loss_k - loss_p) <= 1e-3 * loss_p
    again, _f = mlp_fit(x, y, w, ctr, old, **kw)
    assert all(torch.equal(a, b) for a, b in zip(_param_leaves(got),
                                                 _param_leaves(again)))
    x[3, 1] = float("nan")
    kept, kflags = mlp_fit(x, y, w, ctr, old, **kw)
    assert kflags.tolist() == [0, 1]
    assert all(torch.equal(a, b) for a, b in zip(_param_leaves(kept),
                                                 _param_leaves(old)))
    skip, sflags = mlp_fit(x, y, w, ctr, old, lr=1e-3, n_steps=100,
                           need=n_keep + 1)
    assert sflags.tolist() == [1, 0]
    assert all(torch.equal(a, b) for a, b in zip(_param_leaves(skip),
                                                 _param_leaves(old)))


@pytest.mark.parametrize("B,sizes", [(257, (7, 8, 3)),
                                     (65536, (128, 64, 64, 2))])
@pytest.mark.parametrize("p", [1.0, 2.0, math.inf])
def test_mlp_accept_kernel(dev, B, sizes, p):
    """K23's MLP transform and accept against the plain versions: rows and
    distances within 1e-5 of the feature scale, flags equal away from
    eps, log weights equal; the values mode bit-equal to the accept's."""
    from pyabc_tpu_torch.kernels import (mlp_accept, mlp_accept_plain,
                                         mlp_transform_rows,
                                         mlp_transform_rows_plain)

    S, C = sizes[0], sizes[-1]
    g = _gen(dev, B)
    params = _mlp_params(dev, sizes, seed=B)
    params["mu"] = torch.randn(S, generator=g, device=dev)
    params["sd"] = torch.rand(S, generator=g, device=dev) + 0.5
    params["ysd"] = torch.rand(C, generator=g, device=dev) + 0.5
    x0 = torch.randn(S, generator=g, device=dev)
    ss = (x0 + torch.randn(B, S, generator=g, device=dev)).contiguous()
    w = torch.rand(C, generator=g, device=dev) + 0.5
    valid = torch.rand(B, generator=g, device=dev) > 0.1
    logpri = torch.randn(B, generator=g, device=dev)
    logq = torch.randn(B, generator=g, device=dev)
    rows = mlp_transform_rows(ss, params)
    rows_r = mlp_transform_rows_plain(ss, params)
    scale = float(rows_r.abs().max())
    torch.testing.assert_close(rows, rows_r, rtol=1e-5, atol=1e-5 * scale)
    inf = torch.tensor(math.inf, device=dev)
    d_r = mlp_accept_plain(ss, x0, params, w, inf, valid, p=p)[0]
    eps = torch.quantile(d_r, 0.4)
    got = mlp_accept(ss, x0, params, w, eps, valid, p=p, logpri=logpri,
                     logq=logq)
    ref = mlp_accept_plain(ss, x0, params, w, eps, valid, p=p,
                           logpri=logpri, logq=logq)
    dscale = float(ref[0].abs().max())
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5,
                               atol=1e-5 * dscale)
    far = (ref[0] - eps).abs() > 1e-5 * dscale
    assert torch.equal(got[1][far], ref[1][far])
    assert torch.equal(got[2], ref[2])
    assert torch.equal(mlp_accept.values(ss, x0, params, w, p=p), got[0])


def test_mlp_learned_statistics_run_on_the_card(dev):
    """The network SIR (8 patches x 8 observations: S 64) under the MLP
    learned statistic (hidden (32, 32), 200 seed steps): K23's MLP fit at
    the seed and each boundary, its transform, accept and values entries
    launched, early reject auto off and bit-identical to off, the fetch
    C' wide after generation 0, one counter read a round, one fetch a
    chunk and the seed fit's read; the adaptive form too."""
    import numpy as np

    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import sir

    shape = dict(n_patches=8, n_obs=8)
    pops = []
    for early in ("auto", False):
        abc = pt.ABCSMC(
            sir.make_network_sir_model(**shape), sir.network_sir_prior(),
            pt.PNormDistance(p=2, sumstat=pt.PredictorSumstat(
                pt.MLPPredictor(hidden=(32, 32), n_steps=200))),
            population_size=1000, eps=pt.MedianEpsilon(), seed=11,
            fused_generations=2, early_reject=early, device=dev)
        abc.new("sqlite://", sir.observed_network_sir(**shape))
        reset_launch_counts()
        h = abc.run(max_nr_populations=5)
        counts, modes = launch_counts(), mode_launch_counts()
        assert h.n_populations == 5
        assert counts["mlp_fit"] == 3 and counts["segment_round"] == 0
        assert modes["mlp_accept:transform"] > 0
        assert modes["mlp_accept:values"] > 0
        assert counts["mlp_accept"] > (modes["mlp_accept:transform"]
                                       + modes["mlp_accept:values"])
        assert h.get_weighted_sum_stats(1)[1].shape[1] == 2
        by = abc.sync_ledger.summary()["by_kind"]
        assert set(by) == {"round_counters", "chunk_fetch",
                           "sumstat_train_fetch"}
        pops.append([h.get_distribution(0, t)[0].to_numpy()
                     for t in range(5)])
    assert all(np.array_equal(a, b) for a, b in zip(*pops))
    abc = pt.ABCSMC(
        sir.make_network_sir_model(**shape), sir.network_sir_prior(),
        pt.AdaptivePNormDistance(p=2, sumstat=pt.PredictorSumstat(
            pt.MLPPredictor(hidden=(32, 32), n_steps=200))),
        population_size=1000, eps=pt.MedianEpsilon(), seed=11,
        fused_generations=2, device=dev)
    abc.new("sqlite://", sir.observed_network_sir(**shape))
    h = abc.run(max_nr_populations=4)
    assert h.n_populations == 4
    assert abc.distance_function.weights[3].shape == (2,)
    assert abc.sync_ledger.summary()["by_kind"]["sumstat_seed"] == 1


def _gp_params(dev, S, C, n, cap, seed, alpha=1e-4):
    """A GP fitted on the host to n rows (n below cap pads), on ``dev``."""
    import numpy as np

    import pyabc_tpu_torch as pt

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, S)) * 2.0 + 5.0
    y = np.tanh(x[:, :C] * 0.3) + 0.05 * rng.normal(size=(n, C))
    gp = pt.GPPredictor(alpha=alpha, cap=cap, seed=seed)
    gp.fit(x, y)
    return gp.device_params(dev), x


@pytest.mark.parametrize("B,S,C,n,cap", [(257, 7, 3, 50, 64),
                                         (65536, 128, 2, 16384, 512),
                                         (4099, 128, 8, 300, 512)])
@pytest.mark.parametrize("p", [1.0, 2.0, math.inf])
def test_gp_accept_kernel(dev, B, S, C, n, cap, p):
    """The GP transform and accept against the plain versions: rows and
    distances within 1e-5 of their scale (sum |k a| + |ymu|: the sum
    cancels at a small alpha), flags equal away from eps, log weights
    equal; the values mode bit-equal to the accept's, the same bits run
    to run."""
    from pyabc_tpu_torch.kernels import (gp_accept, gp_accept_plain,
                                         gp_transform_rows,
                                         gp_transform_rows_plain)
    from pyabc_tpu_torch.kernels.gp_sumstat import (distance_scale,
                                                    transform_scale)

    params, x = _gp_params(dev, S, C, n, cap, seed=B)
    g = _gen(dev, B)
    base = torch.as_tensor(x[:1], dtype=torch.float32, device=dev)
    x0 = (base[0] + 0.5 * torch.randn(S, generator=g, device=dev))
    ss = (base + 2.0 * torch.randn(B, S, generator=g, device=dev))
    ss = ss.contiguous()
    w = torch.rand(C, generator=g, device=dev) + 0.5
    valid = torch.rand(B, generator=g, device=dev) > 0.1
    logpri = torch.randn(B, generator=g, device=dev)
    logq = torch.randn(B, generator=g, device=dev)
    rows = gp_transform_rows(ss, params)
    scale = transform_scale(ss, params).to(torch.float32)
    assert ((rows - gp_transform_rows_plain(ss, params)).abs()
            <= 1e-5 * scale).all()
    inf = torch.tensor(math.inf, device=dev)
    d_r = gp_accept_plain(ss, x0, params, w, inf, valid, p=p)[0]
    eps = torch.quantile(d_r, 0.4)
    got = gp_accept(ss, x0, params, w, eps, valid, p=p, logpri=logpri,
                    logq=logq)
    ref = gp_accept_plain(ss, x0, params, w, eps, valid, p=p,
                          logpri=logpri, logq=logq)
    dscale = distance_scale(ss, x0, params, w).to(torch.float32)
    assert ((got[0] - ref[0]).abs() <= 1e-5 * dscale).all()
    far = (ref[0] - eps).abs() > 1e-5 * dscale
    assert torch.equal(got[1][far], ref[1][far])
    assert torch.equal(got[2], ref[2])
    assert torch.equal(gp_accept.values(ss, x0, params, w, p=p), got[0])
    again = gp_accept(ss, x0, params, w, eps, valid, p=p, logpri=logpri,
                      logq=logq)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("kind", ["gp", "lasso", "model selection",
                                  "fit_every 3", "identity functions"])
def test_host_refit_run_on_the_card(dev, kind):
    """The network SIR (8 patches x 8 observations: S 64) in the host-refit
    mode: every generation runs, the fits land at the boundaries the
    cadence sets, the rounds launch the kind's kernel (the GP kernel, K23's
    linear transform, K5 after the functions), History rows stay S wide,
    and the reads are one a round and one a chunk."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pyabc_tpu_torch.models import sir

    shape = dict(n_patches=8, n_obs=8)
    ss = {"gp": lambda: pt.PredictorSumstat(pt.GPPredictor(alpha=0.1)),
          "lasso": lambda: pt.PredictorSumstat(pt.LassoPredictor(
              alpha=0.001)),
          "model selection": lambda: pt.PredictorSumstat(
              pt.ModelSelectionPredictor([pt.LinearPredictor(alpha=1.0),
                                          pt.GPPredictor(alpha=0.1)])),
          "fit_every 3": lambda: pt.PredictorSumstat(
              pt.LinearPredictor(alpha=1.0), fit_every=3),
          "identity functions": lambda: pt.IdentitySumstat(
              trafos=[lambda x: x, torch.abs])}[kind]()
    abc = pt.ABCSMC(sir.make_network_sir_model(**shape),
                    sir.network_sir_prior(), pt.PNormDistance(p=2,
                                                              sumstat=ss),
                    population_size=1000, eps=pt.MedianEpsilon(), seed=11,
                    fused_generations=2, device=dev)
    abc.new("sqlite://", sir.observed_network_sir(**shape))
    reset_launch_counts()
    h = abc.run(max_nr_populations=6)
    counts = launch_counts()
    assert h.n_populations == 6
    tel = [h.get_telemetry(t) for t in range(6)]
    assert tel[0]["sumstat"]["mode"] == "host"
    refits = [t for t in range(6) if tel[t].get("sumstat_refit")]
    want = {"fit_every 3": [0, 4], "identity functions": []}.get(kind,
                                                                  [0, 2, 4])
    assert refits == want
    assert all(h.get_weighted_sum_stats(t)[1].shape[1] == 64
               for t in range(6))
    if kind == "gp":
        assert counts["gp_accept"] > 0 and counts["linear_accept"] == 0
    if kind in ("lasso", "fit_every 3"):
        assert counts["linear_accept"] > 0 and counts["gp_accept"] == 0
    if kind == "identity functions":
        assert counts["pnorm_accept_weight"] > 0
    assert counts["segment_round"] == 0
    by = abc.sync_ledger.summary()["by_kind"]
    assert set(by) == {"round_counters", "chunk_fetch"}


# ---------- LocalTransition under population sizes and over several models
def _local_k16_inputs(dev, K, n_cap, d, n_live, k_cap, seed=0):
    """Refit params of K models (dims 1, 2, 2 for K 3, model 1 the
    never-fitted placeholder) and each model's K12 arguments."""
    from pyabc_tpu_torch.transition import LocalTransition

    X, w = _local_population(dev, n_cap, d, n_live, seed=seed)
    w = w / w.sum()
    dims = [d] if K == 1 else [1, 2, 2]
    cfgs = [LocalTransition.field_config(n_cap, dk, scaling=1.0, device=dev,
                                         k_cap=k_cap) for dk in dims]
    if K == 1:
        p = LocalTransition.device_fit(X, w, dim=d, scaling=1.0,
                                       k_cap=k_cap,
                                       k_table=cfgs[0]["k_table"])
        return {k: v[None].contiguous() for k, v in p.items()
                if k != "dim"}, dims, cfgs, None
    m = (torch.arange(n_cap, device=dev) % K).to(torch.int32)
    m[m == 1] = 2
    X[m == 0, 1:] = 0.0
    dims_f = torch.tensor([float(x) for x in dims], device=dev)
    zero = LocalTransition.zero_params_models(K, n_cap, d, dims_f)
    w_models = torch.stack([torch.where(m == k, w, torch.zeros_like(w))
                            for k in range(K)]).contiguous()
    flags = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
    params, _r = LocalTransition.device_fit_models(
        X, w_models, zero, flags, dims=dims, configs=cfgs,
        incremental=False)
    probs = torch.stack([w[m == k].sum() for k in range(K)])
    return params, dims, cfgs, probs


@pytest.mark.parametrize("K,n_cap,d,nb,n_live,k_cap", [
    (1, 100, 1, 3, 37, 10), (1, 2048, 4, 4, 2048, 512),
    (3, 512, 2, 4, 512, 128)])
def test_k16_local_mode_kernels(dev, K, n_cap, d, nb, n_live, k_cap):
    """K16's LocalTransition mode: the gather bit-equal, the bootstrap fits
    (K12 and K13 in their bootstrap mode) as the plain versions', the local
    density's CV within 1e-4 relative and its log-densities bit-equal to
    K14's on each fit, a done probe writing nothing, and a whole bisection
    ending where the plain entries end."""
    from pyabc_tpu_torch.kernels import (bootstrap_cv, local_cov,
                                         local_factor, local_logpdf)
    from pyabc_tpu_torch.kernels.bootstrap_cv import (
        MAX_PROBES, bootstrap_local_density_plain,
        bootstrap_local_gather_plain, local_fit, local_fit_buffers,
        n_probes, required_nr)
    from pyabc_tpu_torch.kernels.local_cov import local_cov_plain
    from pyabc_tpu_torch.kernels.local_factor import local_factor_plain

    x, dims, cfgs, probs = _local_k16_inputs(dev, K, n_cap, d, n_live,
                                             k_cap)
    idx, state = bootstrap_cv.draw(x["cdf"], n_boot=nb, seed=5,
                                   generation=3, max_rounds=256, min_n=10,
                                   max_n=n_cap)
    rows, boot_w, go = bootstrap_cv.local_gather(x["thetas"], idx, state)
    rows_p, boot_w_p, go_p = bootstrap_local_gather_plain(x["thetas"], idx,
                                                          state)
    assert torch.equal(rows, rows_p) and torch.equal(boot_w, boot_w_p)
    assert int(go) == int(go_p) == 1
    before = (local_cov.mode_launches["bootstrap"],
              local_factor.mode_launches["bootstrap"])
    fits = local_fit(rows, boot_w, go, state,
                     local_fit_buffers(K, nb, n_cap, d, dev), dims=dims,
                     configs=cfgs)
    assert (local_cov.mode_launches["bootstrap"] - before[0]
            == local_factor.mode_launches["bootstrap"] - before[1]
            == K * nb)
    alive = [k for k in range(K) if probs is None or float(probs[k]) > 0]
    for k in alive:
        kb = k * nb
        field = local_cov_plain(rows[kb], boot_w, **cfgs[k])
        ref, _n = local_factor_plain(field, None, dim=dims[k],
                                     incremental=False)
        assert torch.equal(fits["cnt"][kb], field["cnt"])
        assert _row_close(fits["covs"][kb], field["covs"], 1e-4)
        assert within(fits["chols"][kb], ref["chols"], 1e-5, 1e-4)
    part, ld = bootstrap_cv.local_density(x["thetas"], x["weights"], fits,
                                          state, want_ld=True)
    part_p = bootstrap_local_density_plain(x["thetas"], x["weights"], fits,
                                           state)
    cv = part[..., 0].sum(1) / part[..., 1].sum(1).clamp_min(1e-38)
    cv_p = part_p[..., 0].sum(1) / part_p[..., 1].sum(1).clamp_min(1e-38)
    assert within(cv[alive], cv_p[alive], 0.0, 1e-4)
    for k in alive:
        live = x["weights"][k] > 0
        k14 = local_logpdf(x["thetas"][k].contiguous(), {
            key: fits[key][k * nb] for key in ("thetas", "precs", "lconst",
                                               "weights")})
        assert torch.equal(ld[k * nb][live], k14[live])
    done = state.clone()
    done[3] = 1
    r2, w2, g2 = bootstrap_cv.local_gather(x["thetas"], idx, done)
    assert int(g2) == 0 and float(w2.abs().sum()) == 0.0
    spare = local_fit_buffers(K, nb, n_cap, d, dev)
    local_fit(r2, w2, g2, done, spare, dims=dims, configs=cfgs)
    assert all(float(v.abs().sum()) == 0 for v in spare.values())
    # a whole bisection: kernels against the plain entries
    target = 1.5 * float(cv_p[alive].mean())
    res = required_nr(x["thetas"], x["weights"], x["cdf"], dims=dims,
                      statics=None, seed=5, generation=3, max_rounds=256,
                      target_cv=target, min_n=10, max_n=n_cap,
                      n_bootstrap=nb, model_p=probs, local=cfgs)
    st = state.clone()
    st.copy_(torch.tensor([10, n_cap, n_cap, 0, 0], dtype=torch.int32))
    cvs = torch.zeros(MAX_PROBES, device=dev)
    fp = local_fit_buffers(K, nb, n_cap, d, dev)
    for _ in range(n_probes(10, n_cap)):
        r_p, w_p, _g = bootstrap_local_gather_plain(x["thetas"], idx, st)
        if not int(st[3]):
            for kb in range(K * nb):
                fld = local_cov_plain(r_p[kb], w_p, **cfgs[kb // nb])
                f, _n = local_factor_plain(fld, None, dim=dims[kb // nb],
                                           incremental=False)
                for key in ("thetas", "precs", "lconst", "weights"):
                    fp[key][kb].copy_(f[key])
        pp = bootstrap_local_density_plain(x["thetas"], x["weights"], fp, st)
        bootstrap_cv.bisect(pp, st, cvs, model_p=probs, target=target)
    assert torch.equal(res["state"], st)


@pytest.mark.parametrize("B", [257, 8192])
def test_local_k_gt_1_modes(dev, B):
    """K2's and K14's K > 1 local modes, K15's K > 1 mode and the per-model
    K12 and K13 against their plain versions (config 5's dims, model 1
    dead)."""
    from pyabc_tpu_torch import RV, Distribution
    from pyabc_tpu_torch.core.random_variables import stacked_arrays
    from pyabc_tpu_torch.kernels import (local_logpdf, proposal_drift,
                                         propose_local)
    from pyabc_tpu_torch.kernels.local_logpdf import (
        local_logpdf_models_plain)
    from pyabc_tpu_torch.kernels.proposal_drift import (
        proposal_drift_models_plain)
    from pyabc_tpu_torch.kernels.propose import propose_models_plain

    K, n, d = 3, 1024, 2
    params, dims, cfgs, probs = _local_k16_inputs(dev, K, n, d, n, 256)
    priors = stacked_arrays(
        [Distribution(a=RV("norm", 0.0, 3.0)),
         Distribution(a=RV("norm", 0.0, 3.0), b=RV("uniform", -5.0, 10.0)),
         Distribution(a=RV("norm", 0.0, 3.0), k=RV("norm", 1.0, 3.0))],
        dev)
    log_p = torch.log(probs.clamp_min(1e-38))
    mpk = torch.tensor([[0.7, 0.15, 0.15], [0.15, 0.7, 0.15],
                        [0.15, 0.15, 0.7]], device=dev)
    mpk[:, 1] = 0.0
    mpk = (mpk / mpk.sum(1, keepdim=True)).contiguous()
    stream = _stream(dev, philox.TRANSITION)
    th_k, lp_k, v_k, m_k = propose_local.models(stream, B, priors, log_p,
                                                params, mpk)
    th_p, lp_p, v_p, m_p = propose_models_plain(stream, B, priors, log_p,
                                                params, mpk, local=True)
    same = m_k == m_p
    assert int((~same).sum()) <= B // 1000 and not bool((m_k == 1).any())
    ok = same & v_p & v_k
    assert within(th_k[ok], th_p[ok], 1e-5, 1e-5)
    got = local_logpdf.models(th_k, m_k, params)
    ref = local_logpdf_models_plain(th_k, m_k, params)
    assert within(got, ref, 1e-4, 1e-5)
    g = _gen(dev, 9)
    theta = (params["thetas"][0] * 1.1 + 0.01 * torch.randn(
        n, d, generator=g, device=dev)).contiguous()
    m = (torch.arange(n, device=dev) % K).to(torch.int32)
    m[m == 1] = 2
    theta[m == 0, 1:] = 0.0
    w = torch.full((n,), 1.0 / n, device=dev)
    k_mask = torch.ones(n, dtype=torch.bool, device=dev)
    kw = dict(dims=dims, fitted=torch.tensor([True, False, True],
                                             device=dev),
              gens_since=torch.tensor(3, dtype=torch.int32, device=dev),
              every=4, thr=0.3, min_counts=[x + 1 for x in dims])
    dk = proposal_drift.models(params["thetas"], params["weights"], theta,
                               w, k_mask, m, **kw)
    dp = proposal_drift_models_plain(params["thetas"], params["weights"],
                                     theta, w, k_mask, m, **kw)
    assert within(dk["drift"], dp["drift"], 1e-5, 1e-4)
    for key in ("refit", "flag", "gens_since", "fitted", "w_models"):
        assert torch.equal(dk[key], dp[key]), key


def _grid_inputs(dev, n_cap, n, dims, seed):
    g = _gen(dev, seed)
    d, K = max(dims), len(dims)
    X = torch.randn(n_cap, d, generator=g, device=dev) * 0.7 + 1.0
    w = torch.rand(n_cap, generator=g, device=dev) + 0.1
    w[n:] = 0.0
    m = None
    if K > 1:
        m = torch.randint(0, K, (n_cap,), generator=g, device=dev,
                          dtype=torch.int32)
        dim_of = torch.tensor(dims, device=dev)[m.long()]
        X = torch.where(torch.arange(d, device=dev)[None, :]
                        < dim_of[:, None], X, torch.zeros_like(X))
    return X.contiguous(), (w / w.sum()).contiguous(), m


@pytest.mark.parametrize("n_cap,n,dims,cv,table", [
    (64, 37, (1,), 3, False), (1024, 1000, (4,), 5, False),
    (2048, 1500, (4,), 5, True), (2048, 4, (1,), 5, True),
    (1024, 1000, (1, 2, 2), 5, False)])
def test_grid_search_cv_kernel(dev, n_cap, n, dims, cv, table):
    """K17 (one model, a fold table, K > 1) against its plain version:
    scores within 1e-4 relative and the same bits run to run, the winner
    equal where the two best scores differ by more than 1e-4 relative, the
    params at K8's tolerances (rtol 1e-4, atol 1e-5; prec 1e-4 of its
    largest entry)."""
    from pyabc_tpu_torch.kernels import (grid_search_cv,
                                         grid_search_cv_models_plain,
                                         grid_search_cv_plain)
    from pyabc_tpu_torch.kernels.mvn_fit import STACKED_KEYS
    from pyabc_tpu_torch.transition import fold_ids

    X, w, m = _grid_inputs(dev, n_cap, n, dims, seed=n_cap + n)
    folds = torch.as_tensor(fold_ids(n, cv, n_cap), device=dev)
    F = cv if table else min(cv, n)
    scal = (0.25, 0.5, 1.0, 2.0, 4.0)
    K = len(dims)
    if K == 1:
        kw = dict(n_folds=F, dim=dims[0], scalings=scal,
                  bandwidth_selector=silverman_rule_of_thumb)
        before = grid_search_cv.launches
        got, s, b = grid_search_cv(X, w, folds, **kw)
        assert grid_search_cv.launches == before + 1
        _g2, s2, _b2 = grid_search_cv(X, w, folds, **kw)
        ref, rs, rb = grid_search_cv_plain(X, w, folds, **kw)
        got, ref = [got], [ref]
    else:
        kw = dict(n_folds=F, dims=list(dims), scalings=scal,
                  selectors=[silverman_rule_of_thumb] * K)
        before = grid_search_cv.mode_launches["models"]
        gp, s, b = grid_search_cv.models(X, w, m, folds, **kw)
        assert grid_search_cv.mode_launches["models"] == before + 1
        _g2, s2, _b2 = grid_search_cv.models(X, w, m, folds, **kw)
        rp, rs, rb = grid_search_cv_models_plain(X, w, m, folds, **kw)
        got = [{k: gp[k][i] for k in STACKED_KEYS} for i in range(K)]
        ref = [{k: rp[k][i] for k in STACKED_KEYS} for i in range(K)]
    assert torch.equal(s, s2)
    s, rs, b, rb = (s.reshape(K, -1), rs.reshape(K, -1), b.reshape(K),
                    rb.reshape(K))
    assert within(s, rs, 1e-4 * float(rs.abs().max()), 1e-4)
    for k in range(K):
        top = torch.sort(rs[k], descending=True).values
        if float(top[0] - top[1]) > 1e-4 * float(top[0].abs()):
            assert int(b[k]) == int(rb[k])
        if int(b[k]) != int(rb[k]):
            continue
        for key in ("thetas", "weights", "center", "cdf", "chol", "logdet",
                    "quad"):
            assert within(got[k][key], ref[k][key], 1e-5, 1e-4), key
        assert _row_close(got[k]["prec"], ref[k]["prec"], 1e-4)


def test_local_logpdf_over_the_ring(dev):
    """K14 at the record ring's shape of a pop-16384 noisy run (131072
    rows, 40 % unwritten zeros) under a LocalTransition fit of 16384 rows
    (d 4): within 1e-4 + 1e-5 relative of its plain version."""
    from pyabc_tpu_torch.kernels import local_logpdf, local_logpdf_plain
    from pyabc_tpu_torch.transition import LocalTransition

    n, d, B = 16384, 4, 131072
    g = _gen(dev, 16)
    X = lv.default_prior().rvs_array(n, g, dev).contiguous()
    w = torch.rand(n, generator=g, device=dev) + 0.1
    w = (w / w.sum()).contiguous()
    cfg = LocalTransition.field_config(n, d, scaling=1.0, device=dev,
                                       k_cap=4096)
    params = LocalTransition.device_fit(
        X, w, dim=d, scaling=1.0, k_cap=cfg["k_cap"], selection="threshold",
        k_table=cfg["k_table"])
    ring = lv.default_prior().rvs_array(B, g, dev)
    ring[int(0.6 * B):] = 0.0
    ring = ring.contiguous()
    assert within(local_logpdf(ring, params),
                  local_logpdf_plain(ring, params), 1e-4, 1e-5)


@pytest.mark.parametrize("mode", ["constant", "list", "models"])
def test_grid_search_runs_on_the_card(dev, mode):
    """ABCSMC with GridSearchCV on the card in each mode: K17 launched
    every generation (its K > 1 mode for the pair), K8 never, the winner in
    the grid."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (grid_search_cv, launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import gaussian
    from pyabc_tpu_torch.models import model_selection as msel

    def grid():
        return pt.GridSearchCV(pt.MultivariateNormalTransition(),
                               {"scaling": [0.5, 1.0, 2.0]}, cv=4)

    reset_launch_counts()
    if mode == "models":
        models, priors, _an = msel.tractable_pair()
        abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                        population_size=400, eps=pt.MedianEpsilon(),
                        transitions=[grid(), grid()], device=dev)
        obs = {"x": 0.7}
    else:
        ps = (300 if mode == "constant"
              else pt.ListPopulationSize([200, 260, 150, 220]))
        abc = pt.ABCSMC(gaussian.make_mean_only_model(),
                        gaussian.mean_only_prior(), pt.PNormDistance(p=2),
                        population_size=ps, eps=pt.MedianEpsilon(),
                        fused_generations=3, transitions=grid(), device=dev)
        obs = {"x": 1.0}
    abc.new("sqlite://", obs)
    h = abc.run(max_nr_populations=4)
    counts = launch_counts()
    assert counts["grid_search_cv"] == 4 and counts["mvn_fit"] == 0
    if mode == "models":
        assert grid_search_cv.mode_launches["models"] == 4
    if mode == "list":
        sizes = h.get_nr_particles_per_population()
        assert [int(v) for v in sizes[sizes.index >= 0]] == [200, 260, 150,
                                                             220]
    for t in range(4):
        chosen = h.get_telemetry(t)["gridsearch_scaling"]
        assert set(np.atleast_1d(chosen)) <= {0.5, 1.0, 2.0}


# ---------------------------------------------- the host loop (K4, K26)
@pytest.mark.parametrize("B,n", [(1, 10), (777, 3), (65536, 10), (4096, 13)])
def test_gaussian_simulate_kernel(dev, B, n):
    """K4's Gaussian kernel against its plain version on the same Philox
    words: within rel 1e-6 of each lane's |mu| + |sigma|."""
    from pyabc_tpu_torch.kernels.gaussian_simulate import (
        gaussian_simulate, gaussian_simulate_plain)
    from pyabc_tpu_torch.models import gaussian

    theta = propose(_stream(dev, philox.PRIOR), B,
                    gaussian.default_prior().arrays(dev))[0]
    sim = _stream(dev, philox.SIM_NOISE)
    got = gaussian_simulate(theta, n=n, stream=sim)
    ref = gaussian_simulate_plain(theta, n=n, stream=sim)
    scale = (theta[:, 0].abs() + theta[:, 1].abs())[:, None]
    assert torch.isfinite(got).all()
    assert float(((got - ref).abs() / scale).max()) <= 1e-6


@pytest.mark.parametrize("columns", [(0, 1), (0, -1), (-1, 0), (1, 0)])
def test_gaussian_simulate_columns(dev, columns):
    """K4's Gaussian kernel writes the observed statistics in spec order
    (an observed mean or std alone is one column) as its plain version
    does, within rel 1e-6 of |mu| + |sigma|."""
    from pyabc_tpu_torch.kernels.gaussian_simulate import (
        gaussian_simulate, gaussian_simulate_plain)
    from pyabc_tpu_torch.models import gaussian

    theta = propose(_stream(dev, philox.PRIOR), 5000,
                    gaussian.default_prior().arrays(dev))[0]
    sim = _stream(dev, philox.SIM_NOISE)
    got = gaussian_simulate(theta, n=10, stream=sim, columns=columns)
    ref = gaussian_simulate_plain(theta, n=10, stream=sim, columns=columns)
    scale = (theta[:, 0].abs() + theta[:, 1].abs())[:, None]
    assert got.shape == ref.shape == (5000, sum(c >= 0 for c in columns))
    assert float(((got - ref).abs() / scale).max()) <= 1e-6


def test_mean_only_observation_on_the_card(dev):
    """Config 1's model observed through its mean alone: every round on
    the card simulates through K4's Gaussian kernel (one column a row)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pyabc_tpu_torch.models import gaussian

    abc = pt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                    pt.PNormDistance(p=2), population_size=500, seed=1,
                    fused_generations=1, device=dev)
    abc.new("sqlite://", {"mean": 0.4})
    reset_launch_counts()
    h = abc.run(max_nr_populations=3)
    rounds = sum(g["rounds"] for g in abc.generation_log)
    assert h.max_t == 2
    assert launch_counts()["gaussian_simulate"] >= rounds > 0
    df, w = h.get_distribution(0, h.max_t)
    assert abs(float(np.sum(df["mu"] * w)) - 0.4) < 0.3


def _device_kernels(fn) -> list | None:
    """The device kernels ``fn`` launches, from torch.profiler (memory
    copies left out); None when the profiler records no device op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not names:
        return None
    return [n for n in names if not n.startswith(("Memcpy", "Memset"))]


#: the lane kernels of one config 1 round in each mode
ROUND_LANES = {"prior": ("propose", "gaussian_simulate",
                         "pnorm_accept_weight"),
               "calibration": ("propose", "gaussian_simulate"),
               "transition": ("propose", "mvn_mixture_logpdf",
                              "gaussian_simulate", "pnorm_accept_weight")}


@pytest.mark.parametrize("mode", ["prior", "calibration", "transition"])
def test_round_kernel_modes_on_the_card(dev, mode):
    """K26's round kernel launches its lane kernels once each and no
    other device kernel (the wrappers' counts; the profiler's device ops
    where it records them), and matches the same round on the CPU (the
    same Philox words): theta, rows and distances within 1e-5 + 1e-5 |x|,
    flags equal away from eps."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.core.random import RoundKey, generation_key
    from pyabc_tpu_torch.kernels import launch_counts
    from pyabc_tpu_torch.models import gaussian

    B, out = 4096, {}
    for where in (dev, torch.device("cpu")):
        abc = pt.ABCSMC(gaussian.make_gaussian_model(),
                        gaussian.default_prior(), pt.PNormDistance(p=2),
                        population_size=1000, fused_generations=1, seed=3,
                        device=where)
        abc.new("sqlite://", {"mean": 0.4, "std": 1.1})
        ctx = abc._build_context(1000, 0.0)
        rng = np.random.default_rng(0)
        abc.transitions[0].fit(
            np.stack([rng.normal(0.4, 0.3, 500),
                      rng.uniform(0.5, 1.3, 500)], 1), np.full(500, 0.002))
        if mode == "transition":
            _m, dyn = ctx.build_dyn_args(t=1, eps_value=0.6,
                                         model_probabilities={0: 1.0},
                                         transitions=abc.transitions)
            key = RoundKey(1, 2)
        else:
            _m, dyn = ctx.build_dyn_args(t=0, eps_value=0.9)
            key = RoundKey(generation_key(-1) if mode == "calibration"
                           else 0, 1)
        res = ctx.round(key, B, mode, dyn)
        out[where.type] = {k: v.cpu() for k, v in res.items()}
        if where.type == "cuda":
            before = launch_counts()
            ops = _device_kernels(lambda: ctx.round(key, B, mode, dyn))
            after = launch_counts()
            delta = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            assert delta == {k: 1 for k in ROUND_LANES[mode]}
            # the profiler can drop an event of its window (one card run
            # missed a round's first kernel, its launch counted): a count
            # below the lanes is taken again, at most twice; above them
            # fails at once
            for _ in range(2):
                if ops is None or len(ops) >= len(ROUND_LANES[mode]):
                    break
                ops = _device_kernels(lambda: ctx.round(key, B, mode, dyn))
            assert ops is None or len(ops) == len(ROUND_LANES[mode]), ops
    a, b = out["cuda"], out["cpu"]
    for k in ("theta", "sumstats", "distance"):
        assert torch.allclose(a[k], b[k], atol=1e-5, rtol=1e-5), k
    far = (b["distance"] - 0.9 if mode != "transition"
           else b["distance"] - 0.6).abs() > 1e-4
    assert torch.equal(a["accepted"][far], b["accepted"][far])
    assert torch.equal(a["valid"], b["valid"])


@pytest.mark.parametrize("mode", ["pipelined", "serial", "rounds"])
def test_host_loop_runs_on_the_card(dev, mode):
    """Config 1 on the card's host loop: the generations run, the reads
    are the host loop's budget and K4's Gaussian kernel simulates every
    round."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (gaussian_simulate, launch_counts,
                                         reset_launch_counts)
    from pyabc_tpu_torch.models import gaussian

    kw = {"pipelined": dict(fused_generations=1),
          "serial": dict(fused_generations=1, pipeline=False),
          "rounds": dict(sampler=pt.BatchedSampler(fused=False))}[mode]
    abc = pt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                    pt.PNormDistance(p=2), population_size=800, seed=2,
                    device=dev, **kw)
    abc.new("sqlite://", {"mean": 0.4, "std": 1.1})
    reset_launch_counts()
    h = abc.run(max_nr_populations=4)
    assert h.max_t == 3
    counts = launch_counts()
    by = abc.sync_ledger.summary()["by_kind"]
    rounds = sum(g["rounds"] for g in abc.generation_log)
    assert counts["gaussian_simulate"] >= rounds > 0
    assert gaussian_simulate.launches == counts["gaussian_simulate"]
    if mode == "rounds":
        # a round (the calibration's too) is one K2 and one K4 launch
        assert set(by) == {"round_fetch"}
        assert by["round_fetch"] == counts["propose"] == counts[
            "gaussian_simulate"]
    else:
        assert set(by) == {"round_counters", "generation_collect"}
        assert by["generation_collect"] == 5


# ------------------------------------------- K24: sharded fused sampling
def _shard_round(dev, B, S, d, seed, models=False):
    g = _gen(dev, seed)
    out = {"accept": torch.rand(B, generator=g, device=dev) < 0.3,
           "valid": torch.rand(B, generator=g, device=dev) < 0.95,
           "theta": torch.randn(B, d, generator=g, device=dev),
           "ss": torch.randn(B, S, generator=g, device=dev) * 3.0 + 1.0,
           "dist": torch.rand(B, generator=g, device=dev),
           "logw": torch.randn(B, generator=g, device=dev)}
    if models:
        out["m"] = torch.randint(0, 3, (B,), generator=g, device=dev,
                                 dtype=torch.int32)
    return out


def _shard_state(dev, n_cap, d, S, n, n_target, models, adaptive):
    res = {"theta": torch.zeros(n_cap, d, device=dev),
           "sumstats": torch.zeros(n_cap, S, device=dev),
           "distance": torch.zeros(n_cap, device=dev),
           "log_weight": torch.full((n_cap,), -math.inf, device=dev),
           "slot": torch.full((n_cap,), -1, dtype=torch.int32, device=dev)}
    if models:
        res["m"] = torch.zeros(n_cap, dtype=torch.int32, device=dev)
    if adaptive:
        res["dfeat"] = torch.zeros(n_cap, S, device=dev)
    buf = torch.zeros(5 + 4 * n, dtype=torch.int32, device=dev)
    buf[4] = n_target
    return res, buf


@pytest.mark.parametrize("B,n_cap,n,n_target", [
    (256, 128, 8, 100), (65536, 16384, 8, 16384), (4096, 1024, 4, 777)])
@pytest.mark.parametrize("models,adaptive", [(False, False), (True, False),
                                             (False, True)])
def test_compact_shards_kernel(dev, B, n_cap, n, n_target, models,
                               adaptive):
    """K24a against its plain version over rounds until every shard is
    finished (finished shards frozen): reservoir, feature rows, model
    column, table and counters bit-exact."""
    from pyabc_tpu_torch.kernels.compact import compact_shards_plain

    d, S = 4, 20
    x0 = torch.randn(S, generator=_gen(dev, 9), device=dev)
    res_k, buf_k = _shard_state(dev, n_cap, d, S, n, n_target, models,
                                adaptive)
    res_p, buf_p = _shard_state(dev, n_cap, d, S, n, n_target, models,
                                adaptive)
    before = compact_round.mode_launches["shards"]
    for r in range(12):
        x = _shard_round(dev, B, S, d, r, models)
        args = (x["accept"], x["valid"], x["theta"], x["ss"], x["dist"],
                x["logw"])
        compact_round.shards(*args, res_k, buf_k[:5], buf_k[5:].view(n, 4),
                             n_shards=n, max_rounds=10, m=x.get("m"), x0=x0)
        compact_shards_plain(*args, res_p, buf_p[:5], buf_p[5:].view(n, 4),
                             n_shards=n, max_rounds=10, m=x.get("m"), x0=x0)
    assert compact_round.mode_launches["shards"] == before + 12
    torch.cuda.synchronize()
    assert torch.equal(buf_k, buf_p)
    for k in res_k:
        assert torch.equal(res_k[k], res_p[k]), k


@pytest.mark.parametrize("n_target,n,cap_loc", [(300, 8, 64), (5, 8, 4),
                                                (16384, 8, 2048)])
def test_shard_mask_kernel(dev, n_target, n, cap_loc):
    from pyabc_tpu_torch.kernels import shard_mask, shard_mask_plain

    g = _gen(dev, n_target)
    table = torch.randint(0, 2 * cap_loc, (n, 4), generator=g, device=dev,
                          dtype=torch.int32)
    counters = torch.tensor([0, 0, 0, 1, n_target], dtype=torch.int32,
                            device=dev)
    got = shard_mask(counters, table, n_shards=n, cap_loc=cap_loc)
    ref = shard_mask_plain(counters, table, n_shards=n, cap_loc=cap_loc)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ns,n,cap_loc", [([16384] * 8, 8, 2048),
                                          ([300, 212, 300], 8, 64),
                                          ([61, 5, 64], 4, 16)])
@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_pack_fetch_merge_kernel(dev, ns, n, cap_loc, dtype):
    """K24c: rows, sum stats and models merged from shard-blocked
    reservoirs, bit-exact against the plain gather."""
    from pyabc_tpu_torch.kernels.pack_fetch import pack_models_plain

    g = _gen(dev, len(ns))
    G, n_cap, d, S = len(ns), n * cap_loc, 4, 20
    theta = [torch.randn(n_cap, d, generator=g, device=dev)
             for _ in range(G)]
    dist = [torch.rand(n_cap, generator=g, device=dev) for _ in range(G)]
    logw = [torch.randn(n_cap, generator=g, device=dev) for _ in range(G)]
    ss = [torch.randn(n_cap, S, generator=g, device=dev) for _ in range(G)]
    ms = [torch.randint(0, 3, (n_cap,), generator=g, device=dev,
                        dtype=torch.int32) for _ in range(G)]
    merge, n_keep = (ns, n, cap_loc), max(ns)
    before = pack_fetch.mode_launches["merge"]
    got = pack_fetch.rows(theta, dist, logw, n_keep=n_keep, dtype=dtype,
                          merge=merge)
    ref = pack_rows_plain(theta, dist, logw, n_keep=n_keep, dtype=dtype,
                          merge=merge)
    assert torch.equal(got, ref)
    assert torch.equal(
        pack_fetch.sumstats(ss, n_keep=n_keep, dtype=dtype, merge=merge),
        cast_rows_plain(ss, n_keep=n_keep, dtype=dtype, merge=merge))
    assert torch.equal(pack_fetch.models(ms, n_keep=n_keep, merge=merge),
                       pack_models_plain(ms, n_keep=n_keep, merge=merge))
    assert pack_fetch.mode_launches["merge"] == before + 3


@pytest.mark.parametrize("B,n,S,rec_cap", [(65536, 8, 20, 16384),
                                           (256, 8, 7, 40)])
def test_moment_fold_shards_kernel(dev, B, n, S, rec_cap):
    """K24d's fold: counts and extrema equal, sums within 1e-5 relative,
    the same bits run to run; a finished shard folds nothing."""
    from pyabc_tpu_torch.kernels import moment_fold
    from pyabc_tpu_torch.kernels.moments import moment_fold_shards_plain
    from pyabc_tpu_torch.ops.scale_reduce import init_moments

    x = _shard_round(dev, B, S, 4, 3)
    x0 = torch.randn(S, generator=_gen(dev, 4), device=dev)
    counters = torch.tensor([0, 0, 0, 0, 8 * n], dtype=torch.int32,
                            device=dev)
    table = torch.zeros(n, 4, dtype=torch.int32, device=dev)
    table[:, 1] = torch.arange(n, device=dev) % 3  # rounds 0, 1, 2
    table[1, 0] = 8                                 # shard 1 finished
    mom0 = init_moments(S, dev).expand(n, -1, -1).contiguous()
    outs = []
    for _ in range(2):
        mom = mom0.clone()
        moment_fold.shards(mom, x["ss"], x["valid"], x0, counters, table,
                           n_shards=n, rec_cap=rec_cap, max_rounds=10)
        outs.append(mom)
    ref = moment_fold_shards_plain(mom0.clone(), x["ss"], x["valid"], x0,
                                   counters, table, n_shards=n,
                                   rec_cap=rec_cap, max_rounds=10)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    got = outs[0]
    assert torch.equal(got[:, 3:], ref[:, 3:])
    assert torch.equal(got[1], mom0[1])
    assert torch.allclose(got[:, :3], ref[:, :3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MOMENT_SCALES)
@pytest.mark.parametrize("p", [2.0, 1.0, math.inf])
def test_moment_finish_shards_kernel(dev, name, p):
    """K24d's finish: the shards combined in order, scale, weights and the
    feature-row distances within 1e-5 relative of the plain version."""
    from pyabc_tpu_torch.kernels import moment_finish
    from pyabc_tpu_torch.kernels.moments import moment_finish_shards_plain
    from pyabc_tpu_torch.ops.scale_reduce import (accumulate_moments,
                                                  init_moments)

    g = _gen(dev, 5)
    n, S, rows = 8, 20, 16384
    x0 = torch.randn(S, generator=g, device=dev)
    mom = torch.stack([accumulate_moments(
        init_moments(S, dev), torch.randn(500, S, generator=g, device=dev)
        * 2.0 + 1.0, torch.rand(500, generator=g, device=dev) < 0.9, x0)
        for _ in range(n)])
    feat = torch.rand(rows, S, generator=g, device=dev) * 4.0
    got = moment_finish.shards(mom, x0, feat, scale_name=name, p=p)
    ref = moment_finish_shards_plain(mom, x0, feat, scale_name=name, p=p)
    for a, b in zip(got, ref):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)


def test_sharded_lv_runs_on_the_card(dev):
    """LV config 2's fixed p-norm at pop 4096 on 8 shards: every
    generation keeps its 4096 rows, K24a, K24b and K24c launch and no
    plain version runs; the refit flags are the chunk cadence's."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                    pt.PNormDistance(p=2), population_size=4096,
                    eps=pt.MedianEpsilon(), seed=7, sharded=8,
                    fused_generations=3, device=dev)
    abc.new("sqlite://", lv.observed_data(seed=123), store_sum_stats=False)
    reset_launch_counts()
    h = abc.run(max_nr_populations=4)
    counts = launch_counts() | mode_launch_counts()
    assert h.max_t == 3
    assert all(h.get_nr_particles_per_population()[t] == 4096
               for t in range(4))
    assert [e[1] for e in abc.refit_events] == [True, False, False, True]
    assert counts["compact_round:shards"] > 0
    assert counts["shard_mask"] == 4
    assert counts["pack_fetch:merge"] > 0
    assert counts["mvn_fit"] == 2


# ------------------------------------------------ K25's sharded twins
AGG_SH_PS = {"pair": (2.0, 1.0), "mixed": (1.0, 2.0, math.inf, 3.0)}


@pytest.mark.parametrize("B,S", [(257, 7), (65536, 40)])
@pytest.mark.parametrize("ps", sorted(AGG_SH_PS))
def test_aggregate_value_rows_kernel(dev, B, S, ps):
    """K25's value-rows mode: the values bit-equal to its values mode and
    within 1e-5 of the plain version, the accept's outputs those of the
    accept alone, one value-rows launch counted."""
    from pyabc_tpu_torch.kernels import aggregate_accept_weight
    from pyabc_tpu_torch.kernels.aggregate import sub_distances_plain

    ps = AGG_SH_PS[ps]
    x = _shard_round(dev, B, S, 2, 11)
    x0 = torch.randn(S, generator=_gen(dev, 12), device=dev)
    params = _agg_params(dev, ps, S, seed=13)
    eps = torch.tensor(10.0, device=dev)
    before = aggregate_accept_weight.mode_launches["value_rows"]
    d, acc, lw, vals = aggregate_accept_weight.value_rows(
        x["ss"], x0, params, eps, x["valid"], ps=ps)
    assert aggregate_accept_weight.mode_launches["value_rows"] == before + 1
    d0, acc0, lw0 = aggregate_accept_weight(x["ss"], x0, params, eps,
                                            x["valid"], ps=ps)
    v = aggregate_accept_weight.values(x["ss"], x0, params, ps=ps)
    torch.cuda.synchronize()
    assert torch.equal(vals, v)
    assert torch.equal(d, d0) and torch.equal(acc, acc0)
    assert torch.equal(lw, lw0)
    ref = sub_distances_plain(x["ss"], x0, params, ps)
    assert torch.allclose(vals, ref, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("B,n_cap,n,n_target", [
    (256, 128, 8, 100), (65536, 16384, 8, 16384)])
@pytest.mark.parametrize("F", [2, 4])
def test_compact_shards_given_rows_kernel(dev, B, n_cap, n, n_target, F):
    """K24a's given-rows mode over rounds until every shard is finished:
    reservoir, the (n_cap, F) feature rows, table and counters bit-exact
    against the plain version; the given-rows launches counted."""
    from pyabc_tpu_torch.kernels.compact import compact_shards_plain

    d, S = 4, 20
    states = []
    for _ in range(2):
        res, buf = _shard_state(dev, n_cap, d, S, n, n_target, False, False)
        res["dfeat"] = torch.zeros(n_cap, F, device=dev)
        states.append((res, buf))
    (res_k, buf_k), (res_p, buf_p) = states
    before = compact_round.mode_launches["given_rows"]
    for r in range(12):
        x = _shard_round(dev, B, S, d, 40 + r)
        f = torch.rand(B, F, generator=_gen(dev, 80 + r), device=dev)
        args = (x["accept"], x["valid"], x["theta"], x["ss"], x["dist"],
                x["logw"])
        compact_round.shards(*args, res_k, buf_k[:5], buf_k[5:].view(n, 4),
                             n_shards=n, max_rounds=10, feat_rows=f)
        compact_shards_plain(*args, res_p, buf_p[:5], buf_p[5:].view(n, 4),
                             n_shards=n, max_rounds=10, feat_rows=f)
    assert compact_round.mode_launches["given_rows"] == before + 12
    torch.cuda.synchronize()
    assert torch.equal(buf_k, buf_p)
    for k in res_k:
        assert torch.equal(res_k[k], res_p[k]), k


@pytest.mark.parametrize("F", [2, 4])
def test_moment_fold_on_value_columns_kernel(dev, F):
    """K24d's fold with F value columns and a zero centre: counts and
    extrema equal, sums within 1e-5 relative, the same bits run to run."""
    from pyabc_tpu_torch.kernels import moment_fold
    from pyabc_tpu_torch.kernels.moments import moment_fold_shards_plain
    from pyabc_tpu_torch.ops.scale_reduce import init_moments

    B, n = 65536, 8
    vals = torch.rand(B, F, generator=_gen(dev, 21), device=dev) * 50.0
    valid = torch.rand(B, generator=_gen(dev, 22), device=dev) < 0.95
    zeros = torch.zeros(F, device=dev)
    counters = torch.tensor([0, 0, 0, 0, 16384], dtype=torch.int32,
                            device=dev)
    table = torch.zeros(n, 4, dtype=torch.int32, device=dev)
    table[2, 0] = 2048  # shard 2 finished
    mom0 = init_moments(F, dev).expand(n, -1, -1).contiguous()
    outs = []
    for _ in range(2):
        mom = mom0.clone()
        moment_fold.shards(mom, vals, valid, zeros, counters, table,
                           n_shards=n, rec_cap=16384, max_rounds=10)
        outs.append(mom)
    ref = moment_fold_shards_plain(mom0.clone(), vals, valid, zeros,
                                   counters, table, n_shards=n,
                                   rec_cap=16384, max_rounds=10)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0][:, 3:], ref[:, 3:])
    assert torch.equal(outs[0][2], mom0[2])
    assert torch.allclose(outs[0][:, :3], ref[:, :3], rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("name", MOMENT_SCALES)
@pytest.mark.parametrize("ps", sorted(AGG_SH_PS))
def test_aggregate_finish_shards_kernel(dev, name, ps):
    """K25's sharded finish: scale, W and distances within 1e-5 relative
    of the plain version, the sub weights copied, the same bits run to
    run, each distance K25's accept distance of its row under the new W
    bit for bit."""
    from pyabc_tpu_torch.kernels import (aggregate_accept_weight,
                                         aggregate_finish)
    from pyabc_tpu_torch.kernels.aggregate import (
        aggregate_finish_shards_plain)
    from pyabc_tpu_torch.ops.scale_reduce import (accumulate_moments,
                                                  init_moments)

    ps = AGG_SH_PS[ps]
    n, S, rows, n_sub = 8, 40, 16384, len(ps)
    g = _gen(dev, 31)
    ss = torch.randn(rows, S, generator=g, device=dev) * 3.0
    x0 = torch.randn(S, generator=g, device=dev)
    params = _agg_params(dev, ps, S, seed=32)
    feat = aggregate_accept_weight.values(ss, x0, params, ps=ps)
    zeros = torch.zeros(n_sub, device=dev)
    mom = torch.stack([accumulate_moments(
        init_moments(n_sub, dev), feat[s * 2048:(s + 1) * 2048],
        torch.rand(2048, generator=g, device=dev) < 0.9, zeros)
        for s in range(n)])
    fac = tuple(1.0 / (1 + k) for k in range(n_sub))
    a = aggregate_finish.shards(mom, feat, params, factors=fac,
                                scale_name=name)
    b = aggregate_finish.shards(mom, feat, params, factors=fac,
                                scale_name=name)
    ref = aggregate_finish_shards_plain(mom, feat, params, factors=fac,
                                        scale_name=name)
    d_acc = aggregate_accept_weight(
        ss, x0, a[1], torch.tensor(math.inf, device=dev),
        torch.ones(rows, dtype=torch.bool, device=dev), ps=ps)[0]
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    for u, v in zip(a, ref):
        assert torch.allclose(u, v, rtol=1e-5, atol=1e-30)
    assert torch.equal(a[1][n_sub:], params[n_sub:])
    assert torch.equal(a[2], d_acc)


@pytest.mark.parametrize("kind", ["adaptive", "schedule"])
def test_sharded_aggregate_lv_runs_on_the_card(dev, kind):
    """LV config 2 under the LV legs' adaptive aggregate, and under a
    fixed aggregate's schedule, at pop 4096 on 8 shards: every generation
    keeps its rows; adaptive: the value rows, the given-rows compaction,
    the fold on the value columns and the sharded finish launch, one
    finish a generation, the weights refit every generation."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.kernels import (launch_counts, mode_launch_counts,
                                         reset_launch_counts)

    subs = [pt.PNormDistance(p=2, weights={"pred": 1, "prey": 0}),
            pt.PNormDistance(p=1, weights={"pred": 0, "prey": 1})]
    dist = (pt.AdaptiveAggregatedDistance(subs) if kind == "adaptive" else
            pt.AggregatedDistance(subs, weights={0: [1, 1], 2: [4, 0.1]}))
    abc = pt.ABCSMC(lv.make_lv_model(), lv.default_prior(), dist,
                    population_size=4096, eps=pt.MedianEpsilon(), seed=0,
                    sharded=8, fused_generations=3, device=dev)
    abc.new("sqlite://", lv.observed_data(seed=0), store_sum_stats=False)
    reset_launch_counts()
    h = abc.run(max_nr_populations=4)
    counts = launch_counts() | mode_launch_counts()
    assert h.max_t == 3
    assert all(h.get_nr_particles_per_population()[t] == 4096
               for t in range(4))
    assert counts["compact_round:shards"] > 0
    assert counts["pnorm_accept_weight"] == 0
    if kind == "schedule":
        assert counts["aggregate_finish"] == 0
        assert counts["aggregate_accept_weight:value_rows"] == 0
        return
    assert counts["aggregate_finish:shards"] == 4
    assert counts["aggregate_accept_weight:value_rows"] > 0
    assert (counts["compact_round:given_rows"]
            == counts["compact_round:shards"])
    assert counts["moment_fold:shards"] > 0
    w = abc.distance_function.weights
    assert sorted(t for t in w if t >= 0) == list(range(5))
    assert all(not np.array_equal(w[t], w[t - 1]) for t in range(1, 5))


# ------------------------------------------- K24e and the lane base
def _mesh_pieces(dev, w, adaptive, seed=0):
    """A rank's pieces at the LV mesh leg's shapes (n_cap 16384 on 8
    shards, d 4, S 40): counters, the clock word, the (v, 4) table, the
    reservoir blocks' slot, theta, sum stats, distance, log weight and,
    adaptive, the distance features and the (v, 6, 40) moment blocks."""
    g = _gen(dev, seed)
    v, R = 8 // w, 16384 // w
    i32 = dict(dtype=torch.int32, device=dev)
    pieces = [torch.randint(0, 99, (5,), generator=g, **i32),
              torch.randint(0, 2, (1,), generator=g, **i32),
              torch.randint(0, 2048, (v * 4,), generator=g, **i32),
              torch.randint(-1, 1 << 20, (R,), generator=g, **i32),
              torch.randn(R, 4, generator=g, device=dev),
              torch.randn(R, 40, generator=g, device=dev),
              torch.rand(R, generator=g, device=dev),
              torch.randn(R, generator=g, device=dev)]
    pieces[-1][:7] = -math.inf
    if adaptive:
        pieces += [torch.rand(R, 40, generator=g, device=dev),
                   torch.randn(v, 6, 40, generator=g, device=dev)]
    return pieces


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("adaptive", [False, True])
def test_mesh_pack_kernel(dev, w, adaptive):
    """K24e's pack of every rank and its unpack of the gathered buffer,
    bit-exact against the plain twin; a None destination is left alone."""
    from pyabc_tpu_torch.kernels import (mesh_pack, mesh_pack_plain,
                                         mesh_unpack, mesh_unpack_plain)

    ranks = [_mesh_pieces(dev, w, adaptive, seed=r) for r in range(w)]
    before = (mesh_pack.launches, mesh_unpack.launches)
    bufs = [mesh_pack(p) for p in ranks]
    for p, b in zip(ranks, bufs):
        assert torch.equal(b, mesh_pack_plain(p))
    buf = torch.stack(bufs)
    lens = [t.numel() for t in ranks[0]]

    def dsts():
        out = [None, None] + [torch.full((w * t.shape[0], *t.shape[1:]), 7,
                                         dtype=t.dtype, device=dev)
                              for t in ranks[0][2:]]
        return out

    got, want = dsts(), dsts()
    mesh_unpack(buf, got, lens)
    torch.cuda.synchronize()
    mesh_unpack_plain(buf, want, lens)
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert (mesh_pack.launches, mesh_unpack.launches) == (
        before[0] + w, before[1] + 1)


def _lane_stream(dev, tag, lane0=0):
    s = _stream(dev, tag)
    return philox.PhiloxStream(s.seed, s.generation, s.tag, s.max_rounds,
                               s.counters, lane0=lane0)


@pytest.mark.parametrize("w", [2, 4])
def test_lane_base_kernels(dev, w):
    """K2 (prior, transition and K > 1 modes), K4's LV and Gaussian
    kernels launched over each rank's lanes [a, b) of B 65536 with the
    lane base a give rows [a, b) of the whole round's launch, bit for bit;
    each such launch counts in its ``lane_base`` mode."""
    from pyabc_tpu_torch.kernels import gaussian_simulate
    from pyabc_tpu_torch.models import gaussian

    B = 65536
    g = _gen(dev, 3)
    prior = lv.default_prior().arrays(dev)
    fit = {"cdf": torch.cumsum(torch.rand(16384, generator=g, device=dev), 0),
           "thetas": prior_rows(dev, 16384, g),
           "chol": torch.eye(4, device=dev) * 0.1}
    theta = prior_rows(dev, B, g)
    model = lv.make_lv_model()
    kw = dict(n_obs=model.n_obs, n_substeps=model.n_substeps, dt=model.dt,
              y0=lv.Y0, noise_sd=model.noise_sd, log_parameters=False)
    gp = gaussian.default_prior().arrays(dev)
    priors = {k: torch.stack([gp[k], gp[k]]) for k in gp
              if isinstance(gp[k], torch.Tensor)}
    priors["dims"] = torch.tensor([2, 2], dtype=torch.int32, device=dev)
    p_model = torch.tensor([0.4, 0.6], device=dev)
    gth = torch.rand(B, 2, generator=g, device=dev) + 0.5
    runs = {
        "propose:prior": lambda s, n, a: propose(s, n, prior),
        "propose:transition": lambda s, n, a: propose(s, n, prior, fit),
        "propose:models": lambda s, n, a: propose.models(s, n, priors,
                                                         p_model),
        "lv_simulate": lambda s, n, a: (lv_simulate(
            theta[a:a + n].contiguous(), None, stream=s, **kw),),
        "gaussian_simulate": lambda s, n, a: (gaussian_simulate(
            gth[a:a + n].contiguous(), n=10, stream=s),),
    }
    modes = (propose.mode_launches["lane_base"],
             lv_simulate.mode_launches["lane_base"],
             gaussian_simulate.mode_launches["lane_base"])
    for name, fn in runs.items():
        tag = philox.SIM_NOISE if "simulate" in name else philox.TRANSITION
        full = fn(_lane_stream(dev, tag), B, 0)
        for r in range(w):
            a, n = r * B // w, B // w
            part = fn(_lane_stream(dev, tag, a), n, a)
            for x, y in zip(full, part):
                assert torch.equal(x[a:a + n], y), (name, r)
    assert (propose.mode_launches["lane_base"] - modes[0]
            == 3 * (w - 1))
    assert lv_simulate.mode_launches["lane_base"] - modes[1] == w - 1
    assert gaussian_simulate.mode_launches["lane_base"] - modes[2] == w - 1


def prior_rows(dev, n, g):
    """n rows of LV's default prior (uniform boxes), drawn on ``g``."""
    prior = lv.default_prior().arrays(dev)
    u = torch.rand(n, 4, generator=g, device=dev)
    return (prior["loc"] + u * (prior["hi"] - prior["loc"])).contiguous()


@pytest.mark.parametrize("B,stride", [(65536, 1), (257, 2)])
def test_mean_only_simulate_kernel(dev, B, stride):
    """K4's mean-only kernel against its plain version, bit for bit: the
    toy's round width and an odd width of stride 2."""
    from pyabc_tpu_torch.kernels import (mean_only_simulate,
                                         mean_only_simulate_plain)

    theta = torch.randn(B, stride, generator=_gen(dev, B), device=dev)
    stream = _stream(dev, philox.SIM_NOISE, seed=B)
    kw = dict(noise_sd=0.5, stream=stream)
    before = mean_only_simulate.launches
    got = mean_only_simulate(theta, **kw)
    assert mean_only_simulate.launches == before + 1
    torch.cuda.synchronize()
    assert got.shape == (B, 1) and torch.isfinite(got).all()
    assert torch.equal(got, mean_only_simulate_plain(theta, **kw))


def _lane_base_cases(dev):
    """The five kernels that took the lane base, at their main paths'
    widths: (wrapper, a launch on (theta, stream), theta)."""
    from dataclasses import replace

    from pyabc_tpu_torch.kernels import (network_sir, ode_family_segments,
                                         ode_family_simulate, sir_simulate,
                                         tau_leap)
    from pyabc_tpu_torch.models import gillespie as gl
    from pyabc_tpu_torch.models import model_selection as msel
    from pyabc_tpu_torch.models import sir

    g = _gen(dev, 5)
    B = 4096
    sm = sir.make_sir_model(noise_sd=10.0)
    skw = dict(n_obs=sm.n_obs, n_substeps=sm.n_substeps, dt=sm.dt,
               n_pop=sir.N_POP, noise_sd=10.0)
    fam = msel.ode_family()[0][0].family
    fkw = dict(n_obs=fam.n_obs, n_substeps=fam.n_substeps, dt=fam.dt,
               y0=msel.Y0, noise_sd=fam.noise_sd)
    specs = msel.ode_family(segments=4)[0][0].family.specs
    m = torch.randint(0, 3, (B,), generator=g, device=dev, dtype=torch.int32)
    bd = gl.make_birth_death_model().chain.kernel[1]
    net = replace(sir.make_network_sir_model().chain.kernel[1], noise_sd=8.0)

    def rates(lo, hi, cols):
        return (lo + (hi - lo) * torch.rand(B, cols, generator=g,
                                            device=dev)).contiguous()

    fam_theta = rates(0.05, 1.0, 2) * torch.tensor([1.0, 9.0], device=dev)
    return {
        "sir_simulate": (sir_simulate, lambda th, st: sir_simulate(
            th, stream=st, **skw), rates(0.1, 0.9, 2)),
        "ode_family_simulate": (ode_family_simulate,
                                lambda th, st: ode_family_simulate(
                                    th, m[B - th.shape[0]:], stream=st,
                                    **fkw), fam_theta + 0.5),
        "ode_family_segments": (ode_family_segments,
                                lambda th, st: ode_family_segments(
                                    specs, th, st,
                                    m=m[B - th.shape[0]:])[0],
                                fam_theta + 0.5),
        "tau_leap": (tau_leap, lambda th, st: tau_leap(bd, th, st)[0],
                     rates(-0.5, 0.5, 2)),
        "network_sir": (network_sir, lambda th, st: network_sir(
            net, th, st)[0], rates(0.1, 0.9, 2)),
    }


@pytest.mark.parametrize("name", ["sir_simulate", "ode_family_simulate",
                                  "ode_family_segments", "tau_leap",
                                  "network_sir"])
def test_lane_base_simulator_kernels(dev, name):
    """K20, K20b's family (unsegmented and its range entry), K19 and K20b
    network launched over the upper half of a round with the lane base
    B/2 give the upper half of the whole round's rows, bit for bit; the
    launch counts in the ``lane_base`` mode."""
    wrapper, fn, theta = _lane_base_cases(dev)[name]
    B = theta.shape[0]
    full = fn(theta, _lane_stream(dev, philox.SIM_NOISE))
    before = wrapper.mode_launches["lane_base"]
    half = fn(theta[B // 2:].contiguous(),
              _lane_stream(dev, philox.SIM_NOISE, B // 2))
    torch.cuda.synchronize()
    assert wrapper.mode_launches["lane_base"] == before + 1
    assert torch.equal(half.isnan(), full[B // 2:].isnan())
    assert torch.equal(half.nan_to_num(), full[B // 2:].nan_to_num())
