"""The rank processes of ``tests/test_torch_mesh.py``: each runs the port's
mesh runs (``ABCSMC(..., mesh=global_mesh("cpu"), sharded=8)``) over Gloo
on the CPU. Not a test module: pytest does not collect it, and it imports
neither JAX nor the JAX package, so a spawned rank is the port alone.

    python tests/torch_mesh_ranks.py RANK WIDTH RDV_FILE OUT_DIR CONFIG...

``spawn`` starts the ranks of one width, each with its own ``file://``
rendezvous (never a fixed port), and ``join`` waits for them with a time
limit, terminating the group and raising with the ranks' output when one is
late or fails. Each rank writes ``OUT_DIR/rank<r>.pkl``: per configuration
the History's arrays (``history_arrays``), the sync ledger, the mesh block
and what the configuration checks.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parent.parent
#: the configurations' seeds, sizes and generations
POP, SHARDS, G, GENS = 128, 8, 3, 6
GAUSS_OBS = {"mean": 0.4, "std": 1.1}
ADAPTIVE_SIZES = [POP, POP - 28, POP, POP - 60, POP, POP]
TOY_SEED, TOY_NOISE_SD, TOY_X = 23, 0.5, 1.0


# ------------------------------------------------------ the configurations
def gauss(mesh=None, sharded=SHARDS, seed=21, store_sum_stats=True, **kw):
    """BASELINE config 1 (K4's Gaussian kernel, Philox noise): pop 128,
    MedianEpsilon, p = 2, G 3."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian

    abc = pt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                    pt.PNormDistance(p=2), population_size=POP,
                    eps=pt.MedianEpsilon(), seed=seed, mesh=mesh,
                    sharded=sharded, fused_generations=G, device="cpu", **kw)
    abc.new("sqlite://", GAUSS_OBS, store_sum_stats=store_sum_stats)
    return abc


def sparse(mesh=None, sharded=SHARDS):
    """Config 1 storing the statistics of every second generation: a
    mesh gathers them only for those generations."""
    return gauss(mesh, sharded, store_sum_stats=2)


def adaptive(mesh=None, sharded=SHARDS, seed=121):
    """``tests/test_sharded.py:355-374``'s headline: a moment-scale
    ``AdaptivePNormDistance`` and a listed size, on config 1's model."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.distance.scale import standard_deviation
    from pyabc_tpu_torch.models import gaussian

    abc = pt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                    pt.AdaptivePNormDistance(
                        p=2, scale_function=standard_deviation),
                    population_size=pt.ListPopulationSize(ADAPTIVE_SIZES),
                    eps=pt.MedianEpsilon(), seed=seed, mesh=mesh,
                    sharded=sharded, fused_generations=G, device="cpu")
    abc.new("sqlite://", GAUSS_OBS)
    return abc


def pair(mesh=None, sharded=SHARDS, seed=22):
    """K = 2: two Philox Gaussian models of 10 and 40 draws."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian

    models = [gaussian.make_gaussian_model(10, "g10"),
              gaussian.make_gaussian_model(40, "g40")]
    abc = pt.ABCSMC(models, [gaussian.default_prior()] * 2,
                    pt.PNormDistance(p=2), population_size=POP,
                    eps=pt.MedianEpsilon(), seed=seed, mesh=mesh,
                    sharded=sharded, fused_generations=G, device="cpu")
    abc.new("sqlite://", GAUSS_OBS)
    return abc


def aggregate(mesh=None, sharded=SHARDS, seed=31):
    """An ``AdaptiveAggregatedDistance`` (span) of p 2 on the mean and
    p 1 on both statistics (K25's value rows and sharded finish)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian

    dist = pt.AdaptiveAggregatedDistance([
        pt.PNormDistance(p=2, weights={"mean": 1.0, "std": 0.0}),
        pt.PNormDistance(p=1)])
    abc = pt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                    dist, population_size=POP, eps=pt.MedianEpsilon(),
                    seed=seed, mesh=mesh, sharded=sharded,
                    fused_generations=G, device="cpu")
    abc.new("sqlite://", GAUSS_OBS)
    return abc


def _toy_run(model, mesh, sharded, seed):
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gaussian

    abc = pt.ABCSMC(model, gaussian.mean_only_prior(), pt.PNormDistance(p=2),
                    population_size=POP, eps=pt.MedianEpsilon(), seed=seed,
                    mesh=mesh, sharded=sharded, fused_generations=G,
                    device="cpu")
    abc.new("sqlite://", {"x": TOY_X})
    return abc


def toy(mesh=None, sharded=SHARDS, seed=TOY_SEED):
    """The conjugate toy (``tests/test_torch_sharded_runs.py``'s): K4's
    mean-only kernel, Philox noise at each lane's global number."""
    from pyabc_tpu_torch.models import gaussian

    return _toy_run(gaussian.make_mean_only_model(noise_sd=TOY_NOISE_SD),
                    mesh, sharded, seed)


def user_toy(mesh=None, sharded=SHARDS, seed=TOY_SEED):
    """The same toy as a user writes it: a ``TorchModel`` drawing
    ``torch.randn`` from the run's generator (each rank's its own)."""
    import torch

    import pyabc_tpu_torch as pt

    def sim(theta, generator):
        z = torch.randn(theta.shape[0], generator=generator,
                        device=theta.device)
        return {"x": theta[:, 0] + TOY_NOISE_SD * z}

    return _toy_run(pt.TorchModel(sim, ["theta"], name="user_toy"), mesh,
                    sharded, seed)


def family(mesh=None, sharded=SHARDS, seed=41):
    """BASELINE config 5: the K = 3 ODE family (noise sd 0.3, K20b), the
    observation of model 1 (``observed_ode_family``)."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import model_selection as msel

    models, priors, _ts = msel.ode_family()
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=POP, eps=pt.MedianEpsilon(), seed=seed,
                    mesh=mesh, sharded=sharded, fused_generations=G,
                    device="cpu")
    abc.new("sqlite://", msel.observed_ode_family(seed=0, true_model=1))
    return abc


def sir(mesh=None, sharded=SHARDS, seed=51):
    """SIR (K20) with measurement noise in the simulator (sd 5) under a
    p-norm."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import sir as tsir

    abc = pt.ABCSMC(tsir.make_sir_model(noise_sd=5.0), tsir.default_prior(),
                    pt.PNormDistance(p=2), population_size=POP,
                    eps=pt.MedianEpsilon(), seed=seed, mesh=mesh,
                    sharded=sharded, fused_generations=G, device="cpu")
    abc.new("sqlite://", tsir.observed_data(seed=0))
    return abc


def birth_death(mesh=None, sharded=SHARDS, seed=61):
    """Unsegmented tau leaping (K19): the birth-death process of BASELINE
    config 3 without segments."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import gillespie as tg

    abc = pt.ABCSMC(tg.make_birth_death_model(), tg.birth_death_prior(),
                    pt.PNormDistance(p=2), population_size=POP,
                    eps=pt.MedianEpsilon(), seed=seed, mesh=mesh,
                    sharded=sharded, fused_generations=G, device="cpu")
    abc.new("sqlite://", tg.observed_birth_death(seed=0))
    return abc


def tractable_pair(mesh=None, sharded=SHARDS, seed=24):
    """K = 2: the tractable pair (K4's mean-only kernel, noise sd 0.6 and
    1.2), each model simulating every lane of a round."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import model_selection as msel

    models, priors, _analytic = msel.tractable_pair()
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=POP, eps=pt.MedianEpsilon(), seed=seed,
                    mesh=mesh, sharded=sharded, fused_generations=G,
                    device="cpu")
    abc.new("sqlite://", {"x": TOY_X})
    return abc


def network_sir(mesh=None, sharded=SHARDS, seed=71):
    """The zoo's segmented network SIR with measurement noise in the
    simulator (sd 8) and early reject off: K20b network's range over every
    segment."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import sir as tsir

    abc = pt.ABCSMC(tsir.make_network_sir_model(noise_sd=8.0),
                    tsir.network_sir_prior(), pt.PNormDistance(p=2),
                    population_size=POP, eps=pt.MedianEpsilon(), seed=seed,
                    mesh=mesh, sharded=sharded, fused_generations=G,
                    early_reject=False, device="cpu")
    abc.new("sqlite://", tsir.observed_network_sir(seed=0))
    return abc


def family_segments(mesh=None, sharded=SHARDS, seed=81):
    """The zoo's segmented ODE family (K = 3, 4 segments, noise sd 0.3)
    with early reject off: K20b's range entry over every segment."""
    import pyabc_tpu_torch as pt
    from pyabc_tpu_torch.models import model_selection as msel

    models, priors, _ts = msel.ode_family(segments=4)
    abc = pt.ABCSMC(models, priors, pt.PNormDistance(p=2),
                    population_size=POP, eps=pt.MedianEpsilon(), seed=seed,
                    mesh=mesh, sharded=sharded, fused_generations=G,
                    early_reject=False, device="cpu")
    abc.new("sqlite://", msel.observed_ode_family(seed=0, segments=4))
    return abc


CONFIGS = {"gauss": gauss, "sparse": sparse, "adaptive": adaptive,
           "pair": pair, "aggregate": aggregate, "toy": toy,
           "user_toy": user_toy, "family": family, "sir": sir,
           "birth_death": birth_death, "tractable_pair": tractable_pair,
           "network_sir": network_sir, "family_segments": family_segments}


def history_arrays(h, K: int = 1) -> dict:
    """Everything a bit-identity claim covers (``tests/test_sharded.py::
    _history_arrays``, each model's): the epsilon trail and every
    generation's thetas, weights and distances, and the statistics of
    each generation that stores them."""
    pops = h.get_all_populations().query("t >= 0")
    out = {"eps": pops["epsilon"].to_numpy()}
    for t in pops["t"]:
        t = int(t)
        for m in range(K):
            df, w = h.get_distribution(m, t)
            out[f"theta_{m}_{t}"] = df.to_numpy()
            out[f"w_{m}_{t}"] = np.asarray(w)
        out[f"d_{t}"] = h.get_weighted_distances(t)["distance"].to_numpy()
        if h.wants_sum_stats(t):
            out[f"ss_{t}"] = h.get_weighted_sum_stats(t)[1]
    return out


def run_config(name: str, mesh) -> dict:
    abc = CONFIGS[name](mesh)
    h = abc.run(max_nr_populations=GENS)
    return {"arrays": history_arrays(h, abc.K),
            "ledger": abc.sync_ledger.summary(),
            "mesh": abc.mesh_snapshot(),
            "gens": len(abc.generation_log),
            "generator_seed": int(abc.generator.initial_seed()),
            "weights": {int(t): np.asarray(w) for t, w in getattr(
                abc.distance_function, "weights", {}).items()}}


# ------------------------------------------------- checks of one rank each
def walltime(mesh, rank: int) -> dict:
    """A ``max_walltime`` stop: the primary's clock moves one second a
    read, the other rank's never moves, and both end at the same
    generation (the primary's decision rides the gather)."""
    from pyabc_tpu_torch.inference import smc

    tick = [0.0]

    def moving():
        tick[0] += 1.0
        return tick[0]

    clock = moving if rank == 0 else (lambda: 0.0)
    saved = smc.time
    smc.time = SimpleNamespace(perf_counter=clock)
    try:
        abc = gauss(mesh)
        h = abc.run(max_nr_populations=GENS, max_walltime=12.0)
    finally:
        smc.time = saved
    return {"max_t": int(h.max_t), "arrays": history_arrays(h)}


def db(mesh, rank: int, out: Path) -> dict:
    """Only the primary's db file gets rows, whatever url a rank passes."""
    import sqlite3

    from pyabc_tpu_torch.parallel import distributed as pdist

    path = out / f"db_rank{rank}.db"
    abc = gauss(mesh)
    abc.new(f"sqlite:///{path}", GAUSS_OBS)
    abc.run(max_nr_populations=2)
    rows = 0
    if path.exists():
        con = sqlite3.connect(path)
        try:
            rows = con.execute("SELECT COUNT(*) FROM particles").fetchone()[0]
        finally:
            con.close()
    return {"particles": int(rows),
            "primary_db": pdist.primary_db(f"sqlite:///{path}", mesh),
            "primary_db_group": pdist.primary_db("x"),
            "is_primary": pdist.is_primary(mesh),
            "count": pdist.process_count(mesh),
            "file_exists": path.exists()}


def nccl(mesh, rank: int) -> dict:
    """A mesh over an NCCL group is refused, naming why (the group's
    backend reported as NCCL)."""
    from pyabc_tpu_torch.parallel import mesh as pmesh

    saved = pmesh.dist.get_backend
    pmesh.dist.get_backend = lambda group=None: "nccl"
    try:
        gauss(mesh)
        return {"raised": None}
    except NotImplementedError as exc:
        return {"raised": str(exc)}
    finally:
        pmesh.dist.get_backend = saved


def rank_main(rank: int, width: int, rdv: str, out: str,
              names: list[str]) -> None:
    import torch

    torch.set_num_threads(1)
    from pyabc_tpu_torch.parallel import distributed as pdist

    out = Path(out)
    pdist.initialize(f"file://{rdv}", num_processes=width, process_id=rank,
                     timeout=120)
    try:
        mesh = pdist.global_mesh("cpu")
        results = {}
        for name in names:
            if name == "walltime":
                results[name] = walltime(mesh, rank)
            elif name == "db":
                results[name] = db(mesh, rank, out)
            elif name == "nccl":
                results[name] = nccl(mesh, rank)
            else:
                results[name] = run_config(name, mesh)
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------- spawn and join
def spawn(width: int, names: list[str], out: Path) -> list:
    """Start the ``width`` ranks of one group (a fresh ``file://``
    rendezvous in ``out``) -> their processes."""
    out.mkdir(parents=True, exist_ok=True)
    rdv = out / "rendezvous"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), str(r), str(width),
         str(rdv), str(out), *names], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(width)]


def join(procs: list, out: Path, timeout: float) -> list[dict]:
    """Wait for every rank until ``timeout`` seconds have passed; a late
    or failed rank terminates the group and raises with its output ->
    each rank's results."""
    deadline = time.monotonic() + timeout
    logs = [""] * len(procs)
    try:
        for r, p in enumerate(procs):
            left = max(deadline - time.monotonic(), 0.1)
            logs[r], _ = p.communicate(timeout=left)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for r, p in enumerate(procs):
            logs[r] += p.communicate()[0] or ""
        raise RuntimeError(f"mesh ranks late after {timeout} s:\n"
                           + "\n".join(logs))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            f"mesh ranks {bad} failed:\n"
            + "\n".join(f"--- rank {r} (exit {procs[r].returncode})\n"
                        f"{logs[r]}" for r in range(len(procs))))
    results = []
    for r in range(len(procs)):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
              sys.argv[5:])
