"""Card tests: each hand-written kernel (K3-K6) against its plain PyTorch
version on the CUDA device, at small shapes and at the main-path shapes of
BASELINE config 2. Marked ``gpu``; without a card every test skips (the
decision is taken in a fixture, so every worker collects the same tests).

Run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``
(``tests/conftest.py`` imports JAX, which the port's machine needs not have).
"""
import math

import numpy as np
import pytest
import torch

from pyabc_tpu_torch.kernels import (compact_round, compact_round_plain,
                                     lv_simulate, lv_simulate_plain,
                                     mvn_mixture_logpdf,
                                     mvn_mixture_logpdf_plain,
                                     pnorm_accept_weight,
                                     pnorm_accept_weight_plain)
from pyabc_tpu_torch.models import lotka_volterra as lv
from pyabc_tpu_torch.transition import (MultivariateNormalTransition,
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
    noise = model.noise(B, g, dev)
    kw = dict(n_obs=model.n_obs, n_substeps=model.n_substeps, dt=model.dt,
              y0=lv.Y0, noise_sd=model.noise_sd, log_parameters=False)
    return theta, noise, kw


@pytest.mark.parametrize("B,n", SHAPES)
def test_lv_simulate_kernel(dev, B, n):
    theta, noise, kw = _lv_round(dev, B)
    theta[0, 0] = float("nan")
    before = lv_simulate.launches
    got = lv_simulate(theta, noise, **kw)
    assert lv_simulate.launches == before + 1
    ref = lv_simulate_plain(theta, noise, **kw)
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
    q = MultivariateNormalTransition.device_rvs(params, B, g)
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
    assert all(v > 0 for v in launch_counts().values())
    eps = np.asarray(h.get_all_populations()["epsilon"][1:])
    assert np.all(np.isfinite(eps)) and eps[-1] < eps[0]
