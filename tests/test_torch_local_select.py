"""K12's selection from the exact k-th distance (``ops/select.py``'s
``radius_from_kth`` and ``topk_from_kth``, the kernel's algorithm in plain
PyTorch) against the bisection it replaces: the JAX package's
``radius_bisect``, the port's own, and the port's ``topk_neighbors``, over
drawn rows with ties, zeros and -0, +inf, NaN, all-inf rows and fewer
numbers than k. Every comparison is exact (tolerance 0): radii bit for
bit, neighbour lists and counts equal."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from pyabc_tpu.ops import select as jsel  # noqa: E402
from pyabc_tpu_torch.kernels.local_cov import topk_neighbors  # noqa: E402
from pyabc_tpu_torch.ops import select as tsel  # noqa: E402

torch.set_num_threads(1)

#: values a drawn row picks from often, so ties, zeros and -0, +inf and
#: NaN are common
PALETTE = [0.0, -0.0, 0.25, 1.0, 1.0, 3.0, np.inf, np.nan]


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


@st.composite
def rows(draw, max_rows=4, max_n=40):
    n = draw(st.integers(1, max_n))
    r = draw(st.integers(1, max_rows))
    value = st.one_of(
        st.sampled_from(PALETTE),
        st.floats(0.0, 1e6, width=32, allow_nan=False, allow_infinity=False))
    flat = draw(st.lists(value, min_size=r * n, max_size=r * n))
    sq = np.asarray(flat, dtype=np.float32).reshape(r, n)
    if draw(st.booleans()):
        sq[draw(st.integers(0, r - 1))] = np.inf  # an all-invalid row
    k = draw(st.one_of(st.integers(1, n), st.sampled_from([1, n])))
    return sq, k


@settings(max_examples=200, deadline=None, derandomize=True)
@given(rows())
def test_radius_from_kth_equals_both_bisections(case):
    """radius_from_kth bit-equal to the JAX and the port's radius_bisect."""
    sq, k = case
    got = tsel.radius_from_kth(torch.from_numpy(sq), k).numpy()
    port = tsel.radius_bisect(torch.from_numpy(sq), k).numpy()
    ref = np.asarray(jsel.radius_bisect(jnp.asarray(sq), k))
    assert np.array_equal(_bits(got), _bits(port))
    assert np.array_equal(_bits(got), _bits(ref))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(rows())
def test_topk_from_kth_equals_topk_neighbors(case):
    """The k smallest by (distance, index) from the k-th value alone: the
    same neighbour lists and counts as topk_neighbors' stable sort."""
    sq, k = case
    k_cap = sq.shape[1]
    got_idx, got_cnt = tsel.topk_from_kth(torch.from_numpy(sq), k, k_cap)
    idx, cnt = topk_neighbors(torch.from_numpy(sq), torch.tensor(k), k_cap)
    assert torch.equal(got_idx, idx)
    assert torch.equal(got_cnt, cnt)


@settings(max_examples=100, deadline=None, derandomize=True)
@given(rows(max_n=64), st.sampled_from([2, 3, 4]))
def test_strided_radius_equals_threshold_neighbors(case, stride):
    """On the [::stride] subsample with k_sub = ceil(k / stride), as the
    kernel's threshold mode runs it: the radius threshold_neighbors
    returns, bit for bit."""
    sq, k = case
    sub = torch.from_numpy(sq)[:, ::stride]
    got = tsel.radius_from_kth(sub, -(-k // stride))
    _idx, _cnt, r = tsel.threshold_neighbors(torch.from_numpy(sq), k,
                                             sq.shape[1], stride=stride)
    assert np.array_equal(_bits(got.numpy()), _bits(r.numpy()))


EDGE_ROWS = {
    "ties at the k-th": ([0.5, 1.0, 1.0, 1.0, 2.0, 1.0], 3),
    "zeros and -0": ([0.0, -0.0, 0.0, 1.0, -0.0], 2),
    "all zeros, k = m": ([0.0, -0.0, 0.0], 3),
    "all +inf": ([np.inf] * 5, 2),
    "fewer finite than k": ([1.0, np.inf, 2.0, np.inf, np.inf], 4),
    "NaN below k": ([np.nan, 1.0, np.nan, 2.0], 2),
    "NaN past the numbers": ([np.nan, 1.0, np.nan, np.inf], 3),
    "k = 1": ([3.0, 2.0, 2.0, 5.0], 1),
    "k = m": ([3.0, 2.0, np.inf, 5.0], 4),
    "near the float max": ([3.0e38, 3.4e38, 1.0, 2.0e38], 3),
}


@pytest.mark.parametrize("name", list(EDGE_ROWS))
def test_radius_from_kth_edge_rows(name):
    """The edge rows one by one: the radius bit-equal to both bisections,
    the top-k set equal to topk_neighbors'."""
    vals, k = EDGE_ROWS[name]
    sq = np.asarray([vals], dtype=np.float32)
    got = tsel.radius_from_kth(torch.from_numpy(sq), k).numpy()
    assert np.array_equal(
        _bits(got), _bits(tsel.radius_bisect(torch.from_numpy(sq), k)))
    assert np.array_equal(
        _bits(got), _bits(np.asarray(jsel.radius_bisect(jnp.asarray(sq),
                                                        k))))
    got_idx, _c = tsel.topk_from_kth(torch.from_numpy(sq), k, sq.shape[1])
    idx, _c2 = topk_neighbors(torch.from_numpy(sq), torch.tensor(k),
                              sq.shape[1])
    assert torch.equal(got_idx, idx)


def test_kth_key_orders_like_values():
    """The k-th key is the k-th smallest value for distances >= +0 (-0 as
    +0), +inf above every number and NaN above +inf."""
    sq = torch.tensor([[2.0, -0.0, np.inf, 1.0, np.nan, 0.5]])
    vals = [tsel.kth_key(sq, k).to(torch.int32).view(torch.float32).item()
            for k in range(1, 7)]
    assert vals[:5] == [0.0, 0.5, 1.0, 2.0, np.inf]
    assert np.isnan(vals[5])
    assert int(tsel.kth_key(sq, 0)) == -1
    assert int(tsel.kth_key(sq, 7)) == 1 << 32


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16])
def test_field_plan_keeps_every_shape(d):
    """The warp-a-row field's plan from the shape alone: its rows a block
    by the dim bucket (32 up to d 4, 16 at d 8, 8 at d 16), a ring of
    16 KB tiles, the block's shared memory within the card's for every
    size of row (a row keeps a sample and a bracket of its distances, not
    all of them), so no shape is refused; the LV leg's threshold shape
    runs 32 rows a block."""
    from pyabc_tpu_torch.kernels.local_cov import (MAX_SMEM_BYTES,
                                                   dim_bucket, field_plan)

    lv = field_plan(16384, 4, topk=False, stride=4, k_cap=4096)
    assert (lv["m"], lv["buf"], lv["warps"]) == (4096, 1024, 32)
    expect = {1: 32, 2: 32, 4: 32, 8: 16, 16: 8}[dim_bucket(d)]
    for m in (1, 31, 1024, 4096, 58113, 200001):
        for topk in (True, False):
            plan = field_plan(m, d, topk=topk, stride=4, k_cap=min(m, 1000))
            assert plan["warps"] == expect
            assert plan["tc"] % 32 == 0 and plan["tc"] * (dim_bucket(d) + 2) \
                * 4 <= 16384
            assert plan["smem"] <= MAX_SMEM_BYTES
            assert plan["m"] == (m if topk else -(-m // 4))
