"""K1: the plain Philox4x32-10 of the port (``kernels/philox.py``), the
generator the K2 and K4 kernels draw from (``csrc/philox.cuh``).

It replaces the JAX package's threefry key tree as a declared difference
(its bits are not jax.random's), so it is held to Random123's known-answer
vectors, and a draw's place in the stream is held fixed: it depends on
(seed, stream, generation, round, lane, block, word) only.
"""
import math

import numpy as np
import pytest
import torch

from pyabc_tpu_torch import RV, Distribution
from pyabc_tpu_torch.kernels import philox
from pyabc_tpu_torch.kernels.mvn_fit import mvn_fit_plain
from pyabc_tpu_torch.kernels.propose import propose_plain, unbounded_prior
from pyabc_tpu_torch.transition import silverman_rule_of_thumb

torch.set_num_threads(1)

#: Random123's known-answer vectors: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def _stream(tag=philox.TRANSITION, gen=3, rounds=0, seed=11):
    ctr = torch.zeros(4, dtype=torch.int32)
    ctr[philox.ROUND] = rounds
    return philox.PhiloxStream(seed, gen, tag, 256, ctr)


@pytest.mark.parametrize("case", range(len(KAT)))
def test_known_answer_vectors(case):
    ctr, key, want = KAT[case]
    got = philox.philox4x32_10(*(torch.tensor([c]) for c in ctr), key)
    assert [int(w) for w in got] == list(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mulhilo_against_python_ints(seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 2 ** 32, size=1000, dtype=np.int64)
    for m in (philox.M0, philox.M1):
        hi, lo = philox._mulhilo(m, torch.from_numpy(c))
        full = [m * int(x) for x in c]
        assert hi.tolist() == [f >> 32 for f in full]
        assert lo.tolist() == [f & 0xFFFFFFFF for f in full]


def test_uniforms_lie_strictly_inside_the_unit_interval():
    x = torch.tensor([0, 1, 511, 512, 0x7FFFFFFF, 0xFFFFFDFF, 0xFFFFFFFF])
    u = philox.uniform_of(x)
    assert u.dtype == torch.float32
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert float(u[0]) == 2.0 ** -24 and float(u[-1]) == 1.0 - 2.0 ** -24
    big = philox.uniforms(_stream(), torch.arange(100_000), 0, 2)
    assert float(big.min()) > 0.0 and float(big.max()) < 1.0
    assert abs(float(big.mean()) - 0.5) < 4 * math.sqrt(1 / 12 / 1e5)


def test_normals_are_standard():
    z = philox.normals(_stream(), torch.arange(50_000), 5, 4).flatten()
    assert torch.isfinite(z).all()
    # 2e5 normals: mean within 4 se, variance within 4 se (sd(s^2) ~ 1.41)
    assert abs(float(z.mean())) < 4 / math.sqrt(z.numel())
    assert abs(float(z.var()) - 1.0) < 4 * math.sqrt(2 / z.numel())


@pytest.mark.parametrize("B1,B2", [(64, 4096), (1000, 37)])
def test_a_lanes_draws_do_not_depend_on_the_round_size(B1, B2):
    s = _stream(rounds=2)
    a = philox.normals(s, torch.arange(B1), 1, 7)
    b = philox.normals(s, torch.arange(B2), 1, 7)
    k = min(B1, B2)
    assert torch.equal(a[:k], b[:k])
    prior = Distribution(x=RV("norm", 1, 2), y=RV("uniform", -1, 3)).arrays(
        "cpu")
    ta, la, _ = propose_plain(_stream(philox.PRIOR), B1, prior)
    tb, lb, _ = propose_plain(_stream(philox.PRIOR), B2, prior)
    assert torch.equal(ta[:k], tb[:k]) and torch.equal(la[:k], lb[:k])


def test_position_follows_round_generation_tag_and_seed():
    lanes = torch.arange(256)
    base = philox.uniforms(_stream(), lanes, 0, 0)
    assert torch.equal(base, philox.uniforms(_stream(), lanes, 0, 0))
    for other in (_stream(rounds=1), _stream(gen=4),
                  _stream(tag=philox.SIM_NOISE), _stream(seed=12)):
        assert not torch.equal(base, philox.uniforms(other, lanes, 0, 0))
    # the round comes from the device counters, read as a tensor
    s = _stream()
    s.counters[philox.ROUND] = 1
    assert torch.equal(philox.uniforms(s, lanes, 0, 0),
                       philox.uniforms(_stream(rounds=1), lanes, 0, 0))


def _draw(stream, params, j, d):
    """Redraw j of every lane straight from its fixed stream positions."""
    nb = (d + 3) // 4
    lanes = torch.arange(512)
    cdf = params["cdf"]
    u = philox.uniforms(stream, lanes, j * (1 + nb), 0) * cdf[-1]
    idx = torch.searchsorted(cdf, u, right=True).clamp(max=cdf.shape[0] - 1)
    z = philox.normals(stream, lanes, j * (1 + nb) + 1, d)
    return params["thetas"][idx] + z @ params["chol"].T


def test_a_lanes_draws_do_not_depend_on_the_redraw_taken():
    rng = np.random.default_rng(0)
    d = 2
    th = torch.from_numpy(rng.normal(0.5, 0.3, size=(128, d)).astype(
        np.float32))
    w = torch.full((128,), 1 / 128)
    params = mvn_fit_plain(th, w, dim=d, scaling=1.0,
                           bandwidth_selector=silverman_rule_of_thumb)
    stream = _stream()
    draws = [_draw(stream, params, j, d) for j in range(4)]
    # unbounded: redraw 0 is always kept
    free, _, _ = propose_plain(stream, 512, unbounded_prior(d, "cpu"),
                               params)
    assert torch.equal(free, draws[0])
    prior = Distribution(a=RV("uniform", 0.0, 1.0),
                         b=RV("uniform", 0.0, 1.0)).arrays("cpu")
    got, lp, valid = propose_plain(stream, 512, prior, params)
    inside = [((x >= 0) & (x <= 1)).all(dim=1) for x in draws]
    want = draws[3].clone()
    taken = torch.zeros(512, dtype=torch.bool)
    for j in range(4):
        pick = inside[j] & ~taken
        want[pick] = draws[j][pick]
        taken |= pick
    assert torch.equal(got, want)
    assert torch.equal(valid, taken) and torch.isfinite(lp[valid]).all()
    # some lanes took a later redraw
    assert (~inside[0] & taken).any()
