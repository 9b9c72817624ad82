"""The device mesh over torch.distributed (``ABCSMC(..., mesh=global_mesh(),
sharded=8)``): w processes, one device each, Gloo on the CPU.

The JAX package's contract (``tests/test_sharded.py:83-105, 400-420``): a
mesh run is bit for bit the virtual-shard run of the same shard count. The
port's mesh runs, spawned here at widths 1, 2 and 4 over a ``file://``
rendezvous (``tests/torch_mesh_ranks.py``, which imports neither JAX nor
the JAX package), are held to the port's own ``sharded=8`` runs in this
process: config 1's Gaussian, the conjugate toy (K4's mean-only kernel),
config 5's ODE family, SIR with simulator noise and unsegmented tau leaping
at every width (every built-in simulator draws at its lanes' global
numbers; the segmented network SIR and ODE family with early reject off
too), the adaptive distance with a listed size at width 4, K = 2 (K4's
Gaussian pair and the tractable pair) and an adaptive aggregate at width
2. A user simulator drawing ``torch.randn`` from the run's generator is
held in law: each rank's generator is seeded from (seed, rank), and the
posterior agrees with the conjugate answer and the JAX package's
virtual-shard run at ``tests/test_torch_sharded_runs.py``'s tolerances.
Also: the width errors word for word as the JAX package's, one gather a
generation in the sync ledger, History on the primary only, a clock stop
that ends every rank at the same generation, the NCCL refusal, the
refusals of segmented early reject and of an unsharded wide mesh, and the
shard and lane arithmetic the ranks rest on.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402
from pyabc_tpu_torch.kernels import (gaussian_simulate,  # noqa: E402
                                     kernel_accept, lv_simulate, mesh_pack,
                                     mesh_unpack, propose, segment_round)
from pyabc_tpu_torch.kernels.mesh_pack import (mesh_pack_plain,  # noqa: E402
                                               mesh_unpack_plain)
from pyabc_tpu_torch.kernels.philox import PhiloxStream  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402
from pyabc_tpu_torch.models import model_selection as tmsel  # noqa: E402
from pyabc_tpu_torch.models import sir as tsir  # noqa: E402
from pyabc_tpu_torch.ops.shard import rank_block, shard_quota_host  # noqa
from pyabc_tpu_torch.parallel import distributed as pdist  # noqa: E402
from pyabc_tpu_torch.parallel.mesh import MeshRank, rank_seed  # noqa: E402

torch.set_num_threads(1)

#: the groups spawned once for the module: width -> configurations
#: the configurations whose draws every built-in simulator kernel places at
#: its lanes' global numbers, at every width
LANE_BASE = ["toy", "family", "sir", "birth_death", "network_sir",
             "family_segments"]
GROUPS = {1: ["gauss"] + LANE_BASE,
          2: ["gauss", "sparse", "pair", "tractable_pair", "aggregate",
              "user_toy", "walltime", "db", "nccl"] + LANE_BASE,
          4: ["gauss", "adaptive"] + LANE_BASE}
#: seconds a group may take, its start included
JOIN_S = 240.0
POST_MU = gaussian.conjugate_posterior(ranks.TOY_X,
                                       noise_sd=ranks.TOY_NOISE_SD)[0]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{width: each rank's results}: the three groups run side by side,
    each joined with a time limit (a late or failed rank fails them)."""
    base = tmp_path_factory.mktemp("mesh")
    procs = {w: ranks.spawn(w, names, base / f"w{w}")
             for w, names in GROUPS.items()}
    out, err = {}, None
    for w, ps in procs.items():
        try:
            out[w] = ranks.join(ps, base / f"w{w}", JOIN_S)
        except RuntimeError as exc:
            err = err or exc
    if err is not None:
        raise err
    return out


@pytest.fixture(scope="module")
def virtual():
    """The port's virtual-shard runs of the same configurations."""
    out = {}
    for name in ["gauss", "sparse", "adaptive", "pair", "tractable_pair",
                 "aggregate"] + LANE_BASE:
        abc = ranks.CONFIGS[name]()
        h = abc.run(max_nr_populations=ranks.GENS)
        out[name] = (abc, ranks.history_arrays(h, abc.K))
    return out


def _assert_equal(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_array_equal(
            a[k], b[k], err_msg=f"{what}: mesh vs virtual shards at {k}")


# --------------------------------------------------------- bit identity
@pytest.mark.parametrize("width", [1, 2, 4])
def test_mesh_bit_identical_to_virtual_shards(groups, virtual, width):
    """``test_mesh_bit_identical_to_virtual_shards``: config 1's Gaussian
    (Philox noise, K4's Gaussian kernel with the lane base) on 8 shards
    over w ranks equals the 8 virtual shards, epsilon trail, thetas,
    weights and distances of every generation."""
    res = groups[width][0]["gauss"]
    assert res["gens"] == ranks.GENS
    assert res["mesh"]["devices"] == width and res["mesh"]["shards"] == 8
    _assert_equal(res["arrays"], virtual["gauss"][1], f"width {width}")


@pytest.mark.parametrize("width,name", [(4, "adaptive"), (2, "pair"),
                                        (2, "tractable_pair"),
                                        (2, "aggregate"), (2, "sparse")])
def test_configurations_bit_identical(groups, virtual, width, name):
    """The JAX headline's adaptive distance with a listed size at width 4,
    K = 2 model selection (K4's Gaussian pair and the tractable pair on
    K4's mean-only kernel; the model column gathered with the rows), an
    adaptive aggregate (K25's value rows gathered as the feature rows) and
    config 1 storing every second generation's statistics at width 2: bit
    for bit the virtual shards'; the adaptive weights the virtual run's
    too."""
    res = groups[width][0][name]
    _assert_equal(res["arrays"], virtual[name][1], f"{name} w {width}")
    abc_v = virtual[name][0]
    weights = getattr(abc_v.distance_function, "weights", {})
    for t, wv in weights.items():
        np.testing.assert_array_equal(res["weights"][int(t)],
                                      np.asarray(wv))
    if name == "adaptive":
        n = [len(res["arrays"][f"w_0_{t}"]) for t in range(ranks.GENS)]
        assert n == ranks.ADAPTIVE_SIZES
    if name == "sparse":
        assert sorted(k for k in res["arrays"] if k.startswith("ss_")) == [
            f"ss_{t}" for t in range(0, ranks.GENS, 2)]


@pytest.mark.parametrize("width,name", [
    (w, n) for w, names in GROUPS.items() for n in names
    if n not in ("db", "nccl")])
def test_every_rank_holds_the_same_history(groups, width, name):
    """The replicated stage is deterministic: every rank persists the
    primary's arrays (the primary alone keeps them)."""
    res = groups[width]
    for r in range(1, width):
        _assert_equal(res[r][name]["arrays"], res[0][name]["arrays"],
                      f"{name}: rank {r} vs the primary")


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("name", LANE_BASE)
def test_lane_base_models_bit_identical(groups, virtual, width, name):
    """The conjugate toy (K4's mean-only kernel), config 5's K = 3 ODE
    family (K20b, noise sd 0.3; the model column too), SIR with noise sd
    5 under a p-norm (K20), unsegmented birth-death tau leaping (K19), and
    with early reject off the segmented network SIR (K20b network, noise
    sd 8) and the segmented family (K20b's range entry): each rank draws
    its block of a round at the block's global lanes, so the mesh run is
    the 8 virtual shards' bit for bit at every width."""
    res = groups[width][0][name]
    assert res["gens"] == ranks.GENS
    assert res["mesh"]["devices"] == width
    _assert_equal(res["arrays"], virtual[name][1], f"{name} w {width}")


def _jax_toy():
    @jpt.JaxModel.from_function(["theta"], name="gauss_sharded")
    def model(key, theta):
        return {"x": theta[0] + ranks.TOY_NOISE_SD * jax.random.normal(key)}

    abc = jpt.ABCSMC(model, jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0)),
                     jpt.PNormDistance(p=2), population_size=ranks.POP,
                     eps=jpt.MedianEpsilon(), seed=ranks.TOY_SEED,
                     sharded=8, fused_generations=ranks.G)
    abc.new("sqlite://", {"x": ranks.TOY_X})
    return abc.run(max_nr_populations=ranks.GENS)


def _moments(theta, w):
    mu = float(np.sum(theta * w))
    return mu, float(np.sqrt(np.sum(w * (theta - mu) ** 2)))


def test_generator_toy_posterior(groups):
    """A user simulator (``torch.randn`` from the run's generator) on the
    mesh: the law of the virtual run, not its bits. Each rank's generator
    has its own seed (no two ranks draw the same noise); the posterior mean
    is within 0.25 of the conjugate answer and within 0.2 of the JAX
    package's virtual-shard run, the sd within 0.15
    (``test_torch_sharded_runs.py``'s rules)."""
    res = groups[2]
    seeds = [r["user_toy"]["generator_seed"] for r in res]
    assert seeds[0] == ranks.TOY_SEED and len(set(seeds)) == 2
    assert seeds[1] == rank_seed(ranks.TOY_SEED, 1)
    last = ranks.GENS - 1
    arr = res[0]["user_toy"]["arrays"]
    mu, sd = _moments(arr[f"theta_0_{last}"][:, 0], arr[f"w_0_{last}"])
    jh = _jax_toy()
    df, w = jh.get_distribution(0, jh.max_t)
    mu_j, sd_j = _moments(df["theta"].to_numpy(), np.asarray(w))
    assert mu == pytest.approx(POST_MU, abs=0.25)
    assert mu == pytest.approx(mu_j, abs=0.2)
    assert sd == pytest.approx(sd_j, abs=0.15)


# ------------------------------------------------ ledger, db and stops
def _gather_words(width: int, sumstats: bool) -> int:
    """A rank's packed words of config 1: the counters (5), the clock
    word, the (v, 4) table and the reservoir blocks' theta (2), distance,
    log weight and slot, and their sum stats (2) when gathered."""
    v, rows = 8 // width, ranks.POP // width
    return 5 + 1 + 4 * v + rows * (2 + 1 + 1 + 1 + (2 if sumstats else 0))


def test_one_gather_a_generation_in_the_sync_ledger(groups):
    """Each generation gathers once (``mesh_gather``), its bytes the w
    ranks' packed words; besides, a read a round, the calibration's round,
    a fetch a chunk and the calibration's collect."""
    for width in (2, 4):
        res = groups[width][0]["gauss"]
        ledger, mesh = res["ledger"], res["mesh"]
        words = _gather_words(width, True)
        assert ledger["by_kind"]["mesh_gather"] == ranks.GENS
        assert mesh["gathers"] == ranks.GENS
        assert mesh["bytes_per_gather"] == width * words * 4
        assert ledger["bytes"]["mesh_gather"] == ranks.GENS * width * words * 4
        rounds = ledger["by_kind"]["round_counters"]
        assert rounds == sum(mesh["rounds_per_generation"]) + 1
        assert ledger["syncs"] == (rounds + ranks.GENS + 2 + 1)
        assert min(mesh["rounds_per_generation"]) >= 1


def test_sum_stats_ride_only_the_gathers_that_store_them(groups):
    """Storing every second generation's statistics, the even
    generations' gathers carry the reservoir's sum stats and the odd ones'
    do not: the ledger's bytes are three gathers of each size."""
    width = 2
    for r, res in enumerate(groups[width]):
        ledger, mesh = res["sparse"]["ledger"], res["sparse"]["mesh"]
        with_ss = (ranks.GENS + 1) // 2
        nbytes = width * 4 * (with_ss * _gather_words(width, True)
                              + (ranks.GENS - with_ss)
                              * _gather_words(width, False))
        assert mesh["gathers"] == ledger["by_kind"]["mesh_gather"] \
            == ranks.GENS, f"rank {r}"
        assert ledger["bytes"]["mesh_gather"] == mesh["gather_bytes"] \
            == nbytes, f"rank {r}"


def test_only_the_primary_writes_history(groups):
    """Every rank passed its own db file; only the primary's exists (the
    others wrote ``sqlite://``, ``primary_db``'s answer there)."""
    r0, r1 = (r["db"] for r in groups[2])
    assert r0["file_exists"] and not r1["file_exists"]
    # two generations of 128 particles (and the pre-population's one)
    assert r0["particles"] == 2 * ranks.POP + 1 and r1["particles"] == 0
    assert r0["is_primary"] and not r1["is_primary"]
    assert r0["primary_db"].startswith("sqlite:///")
    assert r1["primary_db"] == r1["primary_db_group"] == "sqlite://"
    assert r0["count"] == r1["count"] == 2


def test_walltime_stop_ends_every_rank_at_one_generation(groups):
    """The primary's clock decides a ``max_walltime`` stop and the gather
    carries it: rank 1's clock never moves, yet both ranks stop after the
    same generation, before the generation budget."""
    r0, r1 = (r["walltime"] for r in groups[2])
    assert r0["max_t"] == r1["max_t"] < ranks.GENS - 1
    _assert_equal(r1["arrays"], r0["arrays"], "walltime")


def test_nccl_group_is_refused(groups):
    for r in groups[2]:
        assert "NCCL collectives need one card a rank" in r["nccl"]["raised"]
        assert "item 15" in r["nccl"]["raised"]


# ------------------------------------------------------- width errors
class _FakeMesh:
    """Just the width of a one-dimensional mesh (``_sharded_n`` reads
    ``size()``), like the JAX suite's ``_FakeMesh``."""

    def __init__(self, width: int):
        self.width = width

    def size(self) -> int:
        return self.width


def _port(sharded, width):
    abc = ranks.gauss(None, sharded=8)
    abc.mesh, abc.sharded = _FakeMesh(width), sharded
    return abc


def _jax_mesh(width):
    devs = jax.devices("cpu")
    if len(devs) < width:
        pytest.skip(f"need {width} virtual cpu devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:width]), axis_names=("particles",))


def _jax(sharded, width):
    @jpt.JaxModel.from_function(["theta"], name="gauss_sharded")
    def model(key, theta):
        return {"x": theta[0] + jax.random.normal(key)}

    abc = jpt.ABCSMC(model, jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0)),
                     jpt.PNormDistance(p=2), population_size=ranks.POP,
                     eps=jpt.MedianEpsilon(), seed=1, mesh=_jax_mesh(width),
                     sharded=sharded, fused_generations=ranks.G)
    abc.new("sqlite://", {"x": 1.0})
    return abc


@pytest.mark.parametrize("sharded,width", [(4, 8), (6, 4), (1, 2)])
def test_mesh_width_must_divide_shard_count(sharded, width):
    """Fewer shards than devices, or a width that does not divide them,
    raise the JAX package's ValueError word for word."""
    with pytest.raises(ValueError) as port_err:
        _port(sharded, width)._sharded_n()
    with pytest.raises(ValueError) as jax_err:
        _jax(sharded, width)._sharded_n()
    assert str(port_err.value) == str(jax_err.value)
    assert "must divide" in str(port_err.value)


@pytest.mark.parametrize("width", [2, 4, 8])
def test_divisor_width_mesh_runs_hybrid_shards(width):
    """The width only has to divide the shard count (n / w virtual shards
    a rank); without ``sharded`` the run takes n = w."""
    assert _port(8, width)._sharded_n() == 8
    assert _port(None, width)._sharded_n() == width
    assert _jax(8, width)._sharded_n() == 8


def _gated_models():
    """Each built-in model kind: (its unsegmented form, admitted on a mesh;
    a segmented form of the same kind, refused, and its class name)."""
    small = dict(n_leaps=20, n_obs=4, t1=2.0)
    models, priors = tmsel.ode_family()[:2]
    seg_models, seg_priors = tmsel.ode_family(segments=4)[:2]
    return {
        "SIRModel": ((tsir.make_sir_model(noise_sd=5.0),
                      tsir.default_prior()),
                     (tsir.make_network_sir_model(), tsir.network_sir_prior()),
                     "ChainModel"),
        "OdeFamilyModel": ((models, priors), (seg_models, seg_priors),
                           "SegmentedFamilyModel"),
        "ChainModel": ((tg.make_birth_death_model(**small),
                        tg.birth_death_prior()),
                       (tg.make_birth_death_model(segments=2, **small),
                        tg.birth_death_prior()), "ChainModel"),
    }


def _gate(model, prior, width=2, early_reject=False):
    abc = tpt.ABCSMC(model, prior, tpt.PNormDistance(p=2),
                     population_size=64, sharded=8, early_reject=False,
                     device="cpu")
    abc.mesh_rank = MeshRank(group=None, width=width, rank=0)
    abc.early_reject = early_reject
    abc._mesh_gate()


@pytest.mark.parametrize("what", sorted(_gated_models()))
def test_models_without_a_lane_base_are_refused_on_a_mesh(what):
    """``_mesh_gate``'s two refusals, by their text: a segmented model
    under early reject (K18's segmented round numbers a round's lanes from
    0; early reject on shards is item 15) and a mesh wider than 1 without
    sharded sampling. Every unsegmented built-in model (K20's SIR, K20b's
    family, K19's chain) draws at its lanes' global numbers and is
    admitted, and so is a segmented one with early reject off (its range
    kernels draw at the global lanes too)."""
    (model, prior), (seg, seg_prior), seg_cls = _gated_models()[what]
    _gate(model, prior)
    _gate(model, prior, early_reject="auto")
    _gate(seg, seg_prior)
    for early in ("auto", True):
        with pytest.raises(NotImplementedError) as err:
            _gate(seg, seg_prior, early_reject=early)
        assert str(err.value).startswith(
            f"a segmented {seg_cls} model with early reject on a device "
            f"mesh (early reject on shards)")
        assert "item 15" in str(err.value)
    abc = ranks.gauss(None, sharded=None)
    abc.mesh_rank = MeshRank(group=None, width=2, rank=0)
    with pytest.raises(NotImplementedError,
                       match="2-device mesh without sharded sampling"):
        abc._mesh_gate()


def test_partial_distributed_config_is_refused():
    with pytest.raises(pdist.DistributedConfigError, match="partial"):
        pdist.initialize("tcp://localhost:1", num_processes=2)
    assert not torch.distributed.is_initialized()
    assert pdist.is_primary() and pdist.process_count() == 1
    assert pdist.primary_db("sqlite:///x.db") == "sqlite:///x.db"


# ------------------------------------------- shard and lane arithmetic
@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("n_target", [0, 5, 100, 128, 300])
def test_rank_block_is_the_quota_slice(width, n_target):
    """A rank's target spreads over its v shards exactly as its slice of
    the global quotas (so K24a and K24d take it unchanged), and the ranks'
    lanes and rows tile the round and the reservoir in rank order."""
    quota = shard_quota_host(n_target, 8)
    lanes, rows = [], []
    for rank in range(width):
        blk = rank_block(n_target, 8, width, rank, B=512, n_cap=512)
        np.testing.assert_array_equal(blk.quota,
                                      quota[blk.shard0:blk.shard0 + blk.v])
        np.testing.assert_array_equal(shard_quota_host(blk.target, blk.v),
                                      blk.quota)
        lanes.append((blk.lane0, blk.lanes))
        rows.append((blk.row0, blk.rows))
    assert lanes == [(r * 512 // width, 512 // width) for r in range(width)]
    assert rows == lanes
    assert sum(rank_block(n_target, 8, width, r, B=512, n_cap=512).target
               for r in range(width)) == n_target


def _stream(lane0=0, seed=5, gen=3, tag=2):
    ctr = torch.zeros(5, dtype=torch.int32)
    ctr[1] = 4
    return PhiloxStream(seed, gen, tag, 256, ctr, lane0=lane0)


@pytest.mark.parametrize("a,b", [(0, 64), (64, 128), (96, 160)])
def test_lane_base_gives_the_rows_of_the_whole_round(a, b):
    """K2 (prior, transition and K > 1 modes), K4's LV and Gaussian
    simulators over the lanes [a, b) with the lane base a equal rows
    [a, b) of the whole round's launch, bit for bit."""
    B = 160
    prior = gaussian.default_prior().arrays(torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    thetas = torch.randn(32, 2, generator=gen)
    params = {"cdf": torch.cumsum(torch.rand(32, generator=gen), 0),
              "thetas": thetas, "chol": torch.eye(2) * 0.3}
    full = propose(_stream(), B, prior, params)
    part = propose(_stream(a), b - a, prior, params)
    for x, y in zip(full, part):
        assert torch.equal(x[a:b], y)
    full = propose(_stream(), B, prior)
    part = propose(_stream(a), b - a, prior)
    assert torch.equal(full[0][a:b], part[0])
    priors = {k: v.unsqueeze(0).expand(2, *v.shape).contiguous()
              if isinstance(v, torch.Tensor) else v
              for k, v in prior.items()}
    priors["dims"] = torch.tensor([2, 2], dtype=torch.int32)
    p_model = torch.tensor([0.3, 0.7])
    full = propose.models(_stream(), B, priors, p_model)
    part = propose.models(_stream(a), b - a, priors, p_model)
    for x, y in zip(full, part):
        assert torch.equal(x[a:b], y)
    theta = torch.rand(B, 4, generator=gen) * 0.5 + 0.5
    lv = dict(n_obs=5, n_substeps=2, dt=0.1, y0=(1.0, 0.5), noise_sd=0.1,
              log_parameters=False)
    assert torch.equal(lv_simulate(theta, None, stream=_stream(), **lv)[a:b],
                       lv_simulate(theta[a:b], None, stream=_stream(a),
                                   **lv))
    g = torch.rand(B, 2, generator=gen) + 0.5
    assert torch.equal(
        gaussian_simulate(g, n=10, stream=_stream())[a:b],
        gaussian_simulate(g[a:b], n=10, stream=_stream(a)))


def test_kernels_without_a_lane_base_refuse_one():
    """The kernels that still number a round's lanes from 0 (K21a/K21c's
    stochastic accept, K18's segmented round; their configurations are
    refused before any mesh) raise when handed a stream with a lane base:
    they would draw another block's numbers."""
    with pytest.raises(NotImplementedError,
                       match="kernel_accept on a device mesh"):
        kernel_accept(None, None, None, None, None, None, stream=_stream(64),
                      lin=False, apply_iw=False)
    with pytest.raises(NotImplementedError,
                       match="segment_round on a device mesh"):
        segment_round(None, None, None, _stream(64), imap=None, x0=None,
                      w=None, p=2.0, eps=None, width=1, seg_ctr=None)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_mesh_pack_tiles_in_rank_order(width):
    """K24e's plain pack and unpack: each rank's pieces (int32 and float32
    bits) packed back to back, and the gathered buffer tiled into the
    global arrays piece by piece in rank order, bit for bit; a None
    destination skips its piece."""
    gen = torch.Generator().manual_seed(width)
    per_rank = []
    for r in range(width):
        per_rank.append([torch.randint(-9, 9, (5,), dtype=torch.int32,
                                       generator=gen),
                         torch.randn(6, 3, generator=gen),
                         torch.randn(2, 6, 4, generator=gen)])
    bufs = [mesh_pack(p) for p in per_rank]
    assert torch.equal(bufs[0], mesh_pack_plain(per_rank[0]))
    buf = torch.stack(bufs)
    lens = [5, 18, 48]
    assert buf.shape == (width, sum(lens))
    table = torch.empty(6 * width, 3)
    mom = torch.empty(2 * width, 6, 4)
    mesh_unpack(buf, [None, table, mom], lens)
    assert torch.equal(table, torch.cat([p[1] for p in per_rank]))
    assert torch.equal(mom, torch.cat([p[2] for p in per_rank]))
    nan = torch.tensor([float("nan"), -0.0, float("inf")])
    out = torch.empty(3 * width)
    mesh_unpack_plain(torch.stack([mesh_pack([nan])] * width), [out], [3])
    assert torch.equal(out.view(torch.int32),
                       nan.repeat(width).view(torch.int32))
