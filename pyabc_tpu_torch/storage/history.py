"""History: sqlite persistence of a run (``pyabc_tpu/storage/history.py``
counterpart, sqlite row store only).

The schema and the row layout are the JAX package's, so a database the
port writes opens in ``pyabc_tpu.History`` with the same populations,
weights and epsilons. Appends are synchronous: the port reads the device
once per chunk and persists the chunk's generations right after.
"""
from __future__ import annotations

import datetime
import io
import json
import sqlite3
import threading

import numpy as np
import pandas as pd

PRE_TIME = -1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS abc_smc (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    start_time TEXT,
    json_parameters TEXT,
    distance_function TEXT,
    epsilon_function TEXT,
    population_strategy TEXT
);
CREATE TABLE IF NOT EXISTS populations (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    abc_smc_id INTEGER REFERENCES abc_smc(id),
    t INTEGER,
    population_end_time TEXT,
    nr_samples INTEGER,
    epsilon REAL,
    telemetry TEXT
);
CREATE TABLE IF NOT EXISTS models (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    population_id INTEGER REFERENCES populations(id),
    m INTEGER,
    name TEXT,
    p_model REAL
);
CREATE TABLE IF NOT EXISTS particles (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    model_id INTEGER REFERENCES models(id),
    w REAL,
    distance REAL
);
CREATE TABLE IF NOT EXISTS parameters (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    particle_id INTEGER REFERENCES particles(id),
    name TEXT,
    value REAL
);
CREATE TABLE IF NOT EXISTS samples (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    particle_id INTEGER REFERENCES particles(id),
    name TEXT,
    value BLOB
);
CREATE INDEX IF NOT EXISTS ix_pop_abc ON populations(abc_smc_id, t);
CREATE INDEX IF NOT EXISTS ix_model_pop ON models(population_id);
CREATE INDEX IF NOT EXISTS ix_part_model ON particles(model_id);
CREATE INDEX IF NOT EXISTS ix_param_part ON parameters(particle_id);
CREATE INDEX IF NOT EXISTS ix_sample_part ON samples(particle_id);
"""


def np_to_bytes(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def np_from_bytes(b: bytes) -> np.ndarray:
    return np.load(io.BytesIO(b), allow_pickle=False)


def _db_path(db: str) -> str:
    if db in ("sqlite://", ":memory:"):
        return ":memory:"
    if db.startswith("sqlite:///"):
        return db[len("sqlite:///"):]
    if "://" in db:
        raise NotImplementedError(
            f"History url {db!r}: only sqlite is ported (ROADMAP queue A, "
            f"item 17)")
    return db


class History:
    """One run's record in a sqlite database (``sqlite:///path`` or
    ``sqlite://`` for memory)."""

    def __init__(self, db: str, _id: int | None = None,
                 store_sum_stats: bool | int = True):
        self.db = db
        self.store_sum_stats = store_sum_stats
        self._lock = threading.RLock()
        self._conn = sqlite3.connect(_db_path(db), check_same_thread=False)
        self._conn.executescript(_SCHEMA)
        self._conn.commit()
        self.id = _id if _id is not None else self._latest_id()

    def _latest_id(self) -> int | None:
        return self._conn.execute("SELECT MAX(id) FROM abc_smc").fetchone()[0]

    @staticmethod
    def _now() -> str:
        return datetime.datetime.now().isoformat()

    def wants_sum_stats(self, t: int) -> bool:
        if self.store_sum_stats is True:
            return True
        if self.store_sum_stats is False:
            return False
        k = int(self.store_sum_stats)
        return k > 0 and t % k == 0

    # ------------------------------------------------------------ writing
    def store_initial_data(self, ground_truth_model: int | None,
                           options: dict, observed_summary_statistics: dict,
                           ground_truth_parameter: dict,
                           model_names: list[str],
                           distance_function_json: str,
                           eps_function_json: str,
                           population_strategy_json: str) -> int:
        """Open a new run; observed data is stored at t = PRE_TIME."""
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(
                "INSERT INTO abc_smc (start_time, json_parameters, "
                "distance_function, epsilon_function, population_strategy) "
                "VALUES (?,?,?,?,?)",
                (self._now(), json.dumps(options), distance_function_json,
                 eps_function_json, population_strategy_json))
            self.id = cur.lastrowid
            cur.execute(
                "INSERT INTO populations (abc_smc_id, t, population_end_time,"
                " nr_samples, epsilon) VALUES (?,?,?,?,?)",
                (self.id, PRE_TIME, self._now(), 0, 0.0))
            pop_id = cur.lastrowid
            gt_m = ground_truth_model if ground_truth_model is not None else 0
            cur.execute(
                "INSERT INTO models (population_id, m, name, p_model) "
                "VALUES (?,?,?,?)",
                (pop_id, gt_m, model_names[gt_m] if model_names else "m0",
                 1.0))
            model_id = cur.lastrowid
            cur.execute(
                "INSERT INTO particles (model_id, w, distance) "
                "VALUES (?,?,?)", (model_id, 1.0, 0.0))
            particle_id = cur.lastrowid
            for name, value in (ground_truth_parameter or {}).items():
                cur.execute(
                    "INSERT INTO parameters (particle_id, name, value) "
                    "VALUES (?,?,?)", (particle_id, name, float(value)))
            for name, value in observed_summary_statistics.items():
                cur.execute(
                    "INSERT INTO samples (particle_id, name, value) "
                    "VALUES (?,?,?)",
                    (particle_id, name, np_to_bytes(value)))
            self._conn.commit()
            return self.id

    def append_population(self, t: int, current_epsilon: float, population,
                          nr_simulations: int, model_names: list[str],
                          telemetry: dict | None = None) -> None:
        with self._lock:
            try:
                self._append_locked(t, current_epsilon, population,
                                    nr_simulations, model_names, telemetry)
            except BaseException:
                self._conn.rollback()
                raise

    def _append_locked(self, t, current_epsilon, population, nr_simulations,
                       model_names, telemetry) -> None:
        cur = self._conn.cursor()
        try:
            # take the write lock before allocating particle ids from MAX(id)
            cur.execute("BEGIN IMMEDIATE")
        except sqlite3.OperationalError:
            pass  # already inside a transaction
        cur.execute(
            "INSERT INTO populations (abc_smc_id, t, population_end_time, "
            "nr_samples, epsilon, telemetry) VALUES (?,?,?,?,?,?)",
            (self.id, int(t), self._now(), int(nr_simulations),
             float(current_epsilon),
             json.dumps(telemetry) if telemetry else None))
        pop_id = cur.lastrowid
        probs = population.model_probabilities_array()
        base = cur.execute(
            "SELECT COALESCE(MAX(id), 0) FROM particles").fetchone()[0]
        for m in population.get_alive_models():
            cur.execute(
                "INSERT INTO models (population_id, m, name, p_model) "
                "VALUES (?,?,?,?)",
                (pop_id, int(m),
                 model_names[m] if m < len(model_names) else f"m{m}",
                 float(probs[m])))
            model_id = cur.lastrowid
            idxs = np.flatnonzero(population.ms == m)
            space = population.spaces[m]
            w_model = population.weights[idxs] / probs[m]
            pids = range(base + 1, base + 1 + len(idxs))
            base += len(idxs)
            cur.executemany(
                "INSERT INTO particles (id, model_id, w, distance) "
                "VALUES (?,?,?,?)",
                [(pid, model_id, float(w), float(population.distances[i]))
                 for pid, w, i in zip(pids, w_model, idxs)])
            cur.executemany(
                "INSERT INTO parameters (particle_id, name, value) "
                "VALUES (?,?,?)",
                [(pid, nm, float(v))
                 for pid, i in zip(pids, idxs)
                 for nm, v in zip(space.names,
                                  population.thetas[i, : space.dim])])
            if population.sumstats is not None and self.wants_sum_stats(t):
                cur.executemany(
                    "INSERT INTO samples (particle_id, name, value) "
                    "VALUES (?,?,?)",
                    [(pid, "__flat__", np_to_bytes(population.sumstats[i]))
                     for pid, i in zip(pids, idxs)])
        self._conn.commit()

    # ------------------------------------------------------------ queries
    def _pop_id(self, t: int) -> int | None:
        row = self._conn.execute(
            "SELECT id FROM populations WHERE abc_smc_id=? AND t=?",
            (self.id, int(t))).fetchone()
        return row[0] if row else None

    @property
    def max_t(self) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT MAX(t) FROM populations WHERE abc_smc_id=?",
                (self.id,)).fetchone()
        return row[0] if row and row[0] is not None else PRE_TIME

    @property
    def n_populations(self) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT COUNT(*) FROM populations WHERE abc_smc_id=? "
                "AND t>=0", (self.id,)).fetchone()
        return int(row[0])

    @property
    def total_nr_simulations(self) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT SUM(nr_samples) FROM populations WHERE abc_smc_id=?",
                (self.id,)).fetchone()
        return int(row[0] or 0)

    def get_distribution(self, m: int = 0, t: int | None = None
                         ) -> tuple[pd.DataFrame, np.ndarray]:
        """(parameter DataFrame, within-model weights) for model m at t."""
        t = self.max_t if t is None else t
        with self._lock:
            pop_id = self._pop_id(t)
            if pop_id is None:
                raise KeyError(f"no population t={t}")
            df = pd.read_sql_query(
                """
                SELECT particles.id AS pid, particles.w AS w,
                       parameters.name AS name, parameters.value AS value
                FROM models
                JOIN particles ON particles.model_id = models.id
                JOIN parameters ON parameters.particle_id = particles.id
                WHERE models.population_id = ? AND models.m = ?
                """, self._conn, params=(pop_id, int(m)))
        if df.empty:
            raise KeyError(f"no particles for model {m} at t={t}")
        wide = df.pivot(index="pid", columns="name", values="value")
        w = df.drop_duplicates("pid").set_index("pid")["w"].loc[wide.index]
        w = np.asarray(w, np.float64)
        wide.columns.name = None
        return wide.reset_index(drop=True), w / w.sum()

    def get_model_probabilities(self, t: int | None = None) -> pd.DataFrame:
        """The model probabilities: of generation t (index m, column p),
        or with t None of every generation (index t, one column per model,
        0 where a model is dead), as the JAX package's History."""
        with self._lock:
            if t is None:
                df = pd.read_sql_query(
                    """
                    SELECT populations.t AS t, models.m AS m,
                           models.p_model AS p
                    FROM models JOIN populations
                      ON models.population_id = populations.id
                    WHERE populations.abc_smc_id = ? AND populations.t >= 0
                    """, self._conn, params=(self.id,))
                return df.pivot(index="t", columns="m",
                                values="p").fillna(0.0)
            df = pd.read_sql_query(
                "SELECT m, p_model AS p FROM models WHERE population_id=?",
                self._conn, params=(self._pop_id(self._resolve_t(t)),))
        return df.set_index("m")

    def alive_models(self, t: int | None = None) -> list[int]:
        """The models with positive probability at t (default: the last
        generation)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT m FROM models WHERE population_id=? AND p_model>0",
                (self._pop_id(self._resolve_t(t)),)).fetchall()
        return [r[0] for r in rows]

    def n_alive_models(self, t: int | None = None) -> int:
        return len(self.alive_models(t))

    def _resolve_t(self, t: int | None) -> int:
        return self.max_t if t is None else int(t)

    def get_all_populations(self) -> pd.DataFrame:
        with self._lock:
            return pd.read_sql_query(
                "SELECT t, population_end_time, nr_samples AS samples, "
                "epsilon FROM populations WHERE abc_smc_id=? AND t>=? "
                "ORDER BY t", self._conn, params=(self.id, PRE_TIME))

    def get_nr_particles_per_population(self) -> pd.Series:
        """Particles stored per generation (index t, the observed data's
        t = -1 included), the JAX package's query."""
        with self._lock:
            df = pd.read_sql_query(
                """
                SELECT populations.t AS t, COUNT(particles.id) AS n
                FROM populations
                LEFT JOIN models ON models.population_id = populations.id
                LEFT JOIN particles ON particles.model_id = models.id
                WHERE populations.abc_smc_id = ?
                GROUP BY populations.t ORDER BY populations.t
                """, self._conn, params=(self.id,))
        return df.set_index("t")["n"]

    def get_weighted_distances(self, t: int | None = None) -> pd.DataFrame:
        t = self.max_t if t is None else t
        with self._lock:
            return pd.read_sql_query(
                """
                SELECT particles.distance AS distance,
                       particles.w * models.p_model AS w
                FROM models JOIN particles ON particles.model_id = models.id
                WHERE models.population_id = ?
                """, self._conn, params=(self._pop_id(t),))

    def get_telemetry(self, t: int | None = None) -> dict:
        t = self.max_t if t is None else t
        with self._lock:
            row = self._conn.execute(
                "SELECT telemetry FROM populations WHERE id=?",
                (self._pop_id(t),)).fetchone()
        return json.loads(row[0]) if row and row[0] else {}

    def get_observed_sum_stat(self) -> dict[str, np.ndarray]:
        with self._lock:
            rows = self._conn.execute(
                """
                SELECT samples.name, samples.value FROM models
                JOIN particles ON particles.model_id = models.id
                JOIN samples ON samples.particle_id = particles.id
                WHERE models.population_id = ?
                """, (self._pop_id(PRE_TIME),)).fetchall()
        return {name: np_from_bytes(blob) for name, blob in rows}

    def done(self) -> None:
        with self._lock:
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def __repr__(self):
        return f"History({self.db!r}, id={self.id})"
