"""The lane base of the built-in simulators' plain versions: a launch over
the lanes ``[B/2, B)`` of a round (a device mesh rank's block, the
stream's ``lane0`` at B/2) draws exactly the upper half of the whole
round's rows, bit for bit.

K20 (SIR, noise sd > 0), K20b family (unsegmented, every model, noise sd
0.3) and its range entry (segmented family), K19 (birth-death and the
stochastic LV) and K20b network (noise sd > 0) each number their Philox
lanes ``lane0 + b``; with ``lane0 = 0`` the rows are the old ones.
"""
import numpy as np
import pytest
import torch

from pyabc_tpu_torch.kernels import (network_sir, ode_family_segments,
                                     ode_family_simulate, philox,
                                     sir_simulate, tau_leap)
from pyabc_tpu_torch.kernels.gaussian_simulate import mean_only_simulate
from pyabc_tpu_torch.kernels.network_sir import NetworkSirSpec
from pyabc_tpu_torch.kernels.ode_family import OdeFamilySegSpec
from pyabc_tpu_torch.kernels.tau_leap import (BIRTH_DEATH, STOCHASTIC_LV,
                                              TauLeapSpec)
from pyabc_tpu_torch.models.ode import rk4_dt

torch.set_num_threads(1)

B = 96


def _stream(lane0=0, seed=11):
    ctr = torch.zeros(5, dtype=torch.int32)
    ctr[philox.ROUND] = 3
    return philox.PhiloxStream(seed, 2, philox.SIM_NOISE, 64, ctr,
                               lane0=lane0)


def _uniform(lo, hi, cols, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(lo, hi, (B, cols)).astype(
        np.float32))


def _sir(stream, theta):
    return sir_simulate(theta, n_obs=6, n_substeps=3,
                        dt=rk4_dt(np.linspace(0.0, 30.0, 6), 3),
                        n_pop=1000.0, noise_sd=5.0, stream=stream)


def _family_m(n):
    return torch.arange(n, dtype=torch.int32) % 3


def _family(stream, theta):
    m = _family_m(B)[B - theta.shape[0]:]
    return ode_family_simulate(theta, m, n_obs=5, n_substeps=2,
                               dt=rk4_dt(np.linspace(0.0, 8.0, 5), 2),
                               noise_sd=0.3, stream=stream)


_FAMILY_SEG = [OdeFamilySegSpec(variant=k, n_obs=4, t1=4.0, n_substeps=2,
                                n_seg=2, noise_sd=0.3) for k in range(3)]


def _family_segments(stream, theta):
    m = _family_m(B)[B - theta.shape[0]:]
    return ode_family_segments(_FAMILY_SEG, theta, stream, m=m)[0]


def _tau(kind):
    if kind == BIRTH_DEATH:
        spec = TauLeapSpec(kind=BIRTH_DEATH, x0=(40.0,),
                           stoich=((1.0,), (-1.0,)), channels=(("x", 0),),
                           t1=2.0, n_leaps=8, n_obs=4, n_seg=2)
    else:
        spec = TauLeapSpec(kind=STOCHASTIC_LV, x0=(50.0, 100.0),
                           stoich=((1.0, 0.0), (-1.0, 1.0), (0.0, -1.0)),
                           channels=(("pred", 1), ("prey", 0)), t1=3.0,
                           n_leaps=12, n_obs=4, n_seg=2)
    return lambda stream, theta: tau_leap(spec, theta, stream)[0]


_NET = NetworkSirSpec(n_patches=4, n_obs=4, t1=20.0, n_substeps=2,
                      n_seg=2, noise_sd=4.0)


def _network(stream, theta):
    return network_sir(_NET, theta, stream)[0]


def _family_theta():
    return (_uniform(0.1, 1.0, 2) * torch.tensor([1.0, 8.0])
            + torch.tensor([0.0, 1.0]))


def _mean_only(stream, theta):
    return mean_only_simulate(theta, noise_sd=0.6, stream=stream)


CASES = {
    "sir_simulate": (_sir, lambda: _uniform(0.1, 0.9, 2)),
    "ode_family_simulate": (_family, _family_theta),
    "ode_family_segments": (_family_segments, _family_theta),
    "tau_leap:birth_death": (_tau(BIRTH_DEATH),
                             lambda: _uniform(-0.5, 0.5, 2)),
    "tau_leap:stochastic_lv": (_tau(STOCHASTIC_LV),
                               lambda: _uniform(-1.0, 0.5, 3)),
    "network_sir": (_network, lambda: _uniform(0.1, 0.9, 2)),
    "mean_only_simulate": (_mean_only, lambda: _uniform(-2.0, 2.0, 1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_upper_half_equals_the_whole_rounds_rows(name):
    fn, make = CASES[name]
    theta = make().contiguous()
    full = fn(_stream(), theta)
    half = fn(_stream(B // 2), theta[B // 2:].contiguous())
    assert half.shape == (B // 2, full.shape[1])
    assert torch.isfinite(full).all()
    np.testing.assert_array_equal(half.numpy(), full[B // 2:].numpy())
    # the lower half is another block's draws (the noise moves with lane0)
    other = fn(_stream(B // 2), theta[:B // 2].contiguous())
    assert not torch.equal(other, full[:B // 2])
