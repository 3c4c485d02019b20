"""The k-NN radii kernel (#4) redesigned for Hopper: its arithmetic and its
selection, emulated on the CPU.

The kernel (kernels/csrc/distance.cu) splits the columns among blocks
(``ops.distance.column_splits`` of the n rows against themselves), keeps
each row's k smallest squared distances per split, then merges a row's
lists and takes the k-th.  The
emulation here takes the k smallest of each split with ``topk`` and must
equal ``topk`` over all columns, value for value, with duplicate rows and
massive ties (integer points), at the smoke's and the card tests' sizes.

Its dot products are f32 FMAs summed in depth order from 0, on the plain
version's squared norms.  Emulated here (each FMA as an exact float64
product and sum rounded to f32), with the split-then-merge selection, the
radii stay within the JAX suite's kernel-vs-XLA bound (rtol 1e-4, atol
1e-5, tests/test_pallas_distance.py:20) of the port's plain version and of
the JAX TPU kernel in interpret mode, on the smoke's sets and on unit-norm
rows in groups of near-duplicates, where |a|^2 + |b|^2 - 2 a.b cancels.
"""

import numpy as np
import pytest
import torch

from audio_metrics_tpu.ops.distance import knn_radii_pallas
from audio_metrics_tpu_torch.ops.distance import column_splits, knn_radii_plain
from audio_metrics_tpu_torch.testing import near_duplicate_rows

SMS = 132  # an H100's SM count; the split helper takes the card's own


def _split_select(d2, k, sms=SMS):
    """The kernel's selection: per split the k smallest (+inf filling a
    split of fewer columns), then the k-th smallest of their union."""
    n = d2.shape[1]
    splits, split_cols = column_splits(n, n, sms)
    assert (splits - 1) * split_cols < n <= splits * split_cols and split_cols % 128 == 0
    lists = []
    for s in range(splits):
        part = d2[:, s * split_cols:(s + 1) * split_cols]
        top = torch.topk(part, min(k, part.shape[1]), dim=1, largest=False).values
        lists.append(torch.cat([top, torch.full((d2.shape[0], k - top.shape[1]), np.inf)], 1))
    return torch.sort(torch.cat(lists, 1), dim=1).values[:, k - 1]


def _sq_dists(a, b):
    sq_a, sq_b = (a * a).sum(1), (b * b).sum(1)
    return torch.clamp((sq_a[:, None] + sq_b[None, :]) - 2.0 * (a @ b.T), min=0.0)


@pytest.mark.parametrize("n", [2048, 1237, 300, 129, 20480])
@pytest.mark.parametrize("k", [4, 11, 128])
def test_split_then_merge_equals_topk(n, k):
    """Integer points in {0, 1, 2}^8 (a few hundred distinct squared
    distances, so ties everywhere) with every fifth row duplicated; at
    n = 20480 only 64 query rows."""
    rng = np.random.default_rng(n + k)
    x = rng.integers(0, 3, size=(n, 8)).astype(np.float32)
    x[1::5] = x[0::5][: len(x[1::5])]
    x = torch.from_numpy(x)
    q = x[:64] if n > 4096 else x
    d2 = _sq_dists(q, x)
    want = torch.topk(d2, k, dim=1, largest=False).values[:, k - 1]
    assert torch.equal(_split_select(d2, k), want)
    # the check can fail: the merge keeping the (k-1)-th
    if k > 1 and not torch.equal(want, torch.topk(d2, k - 1, dim=1, largest=False).values[:, -1]):
        assert not torch.equal(_split_select(d2, k - 1), want)


def test_splits_fill_the_card():
    """N = 2048 (the main path's sets): 16 row tiles x 16 splits, one
    128-column tile each; large N: about four blocks per SM."""
    assert column_splits(2048, 2048, SMS) == (16, 128)
    for n in (1237, 10000, 12345, 20480, 100000):
        splits, split_cols = column_splits(n, n, SMS)
        assert -(-n // 128) * splits >= 4 * SMS or split_cols == 128


def _radii_emulated(x, nearest_k, rows=256):
    """The kernel's radii of the first ``rows`` rows of ``x``: each dot
    product an f32 FMA chain in depth order from 0 (an FMA as the float64
    sum of the exact product, rounded to f32), the plain version's squared
    norms, the formula rounded as ``sq_dist`` rounds it, then the
    split-then-merge selection."""
    q = x[:rows].double()
    dot = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32)
    for c in range(x.shape[1]):
        dot = (dot.double() + q[:, c, None] * x[None, :, c].double()).float()
    sq = (x * x).sum(1)
    d2 = torch.clamp((sq[:rows, None] + sq[None, :]) - 2.0 * dot, min=0.0)
    return torch.sqrt(_split_select(d2, nearest_k + 1))


def _sets(kind, noise=1e-2):
    rng = np.random.default_rng(4)
    if kind == "reference":  # the smoke's reference set
        x = rng.standard_normal((2048, 512))
    elif kind == "candidate":  # its candidate set, 0.05 + 1.02 N(0, I)
        x = 0.05 + 1.02 * rng.standard_normal((2048, 512))
    else:  # unit-norm rows in groups of 8 near-duplicates
        base = rng.standard_normal((256, 512))
        x = np.repeat(base / np.linalg.norm(base, axis=1, keepdims=True), 8, axis=0)
        x += noise * rng.standard_normal(x.shape)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind,nearest_k", [("reference", 10), ("candidate", 10),
                                            ("near-duplicates", 3), ("near-duplicates", 10)])
def test_f32_chain_radii_within_the_bound(kind, nearest_k):
    """Near-duplicates with noise 1e-2 per dimension: radii ~0.3 at
    nearest_k = 3 (a near-duplicate), ~1.3 at 10.  Two witnesses: the
    port's plain version and the JAX TPU kernel (interpret mode)."""
    x = _sets(kind)
    got = _radii_emulated(x, nearest_k)
    want = knn_radii_plain(x, nearest_k)[: len(got)]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    jax_r = torch.from_numpy(np.array(knn_radii_pallas(x.numpy(), nearest_k,
                                                         interpret=True)))[: len(got)]
    torch.testing.assert_close(got, jax_r, rtol=1e-4, atol=1e-5)
    # the check can fail: the merge keeping the (k-1)-th
    assert not torch.allclose(got, _radii_emulated(x, nearest_k - 1), rtol=1e-4, atol=1e-5)


def test_near_duplicate_rows_helper():
    """``testing.near_duplicate_rows``, which the smoke and the card tests
    use, makes the set above: radii ~0.3 at k = 4 and ~1.3 at k = 11."""
    x = near_duplicate_rows(2048, 512, seed=5, device="cpu")
    assert x.shape == (2048, 512)
    torch.testing.assert_close(x.norm(dim=1), torch.ones(2048))
    r4, r11 = knn_radii_plain(x, 3), knn_radii_plain(x, 10)
    assert 0.2 < float(r4.min()) and float(r4.max()) < 0.4 and float(r11.min()) > 1.0
