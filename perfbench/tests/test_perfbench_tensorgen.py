import json
import math

import numpy as np
import pytest
import torch

from perfbench import manifest, tensorgen
from perfbench.tests import _tiny  # noqa: F401  (puts the program on sys.path)


def test_zeta_matches_known_value():
    assert tensorgen.zeta(1.3) == pytest.approx(3.9319492118, abs=1e-9)
    assert tensorgen.zeta(2.0) == pytest.approx(math.pi**2 / 6, abs=1e-12)


@pytest.mark.parametrize(("shape", "dist"), [((30, 40, 50), "uniform"),
                                             ((20, 30, 10, 40, 900), "powerlaw")])
def test_generate_is_deterministic_exact_and_canonical(shape, dist):
    a = tensorgen.generate(shape, 3000, distribution=dist, seed=2**31 + 7, device="cpu")
    b = tensorgen.generate(shape, 3000, distribution=dist, seed=2**31 + 7, device="cpu")
    c = tensorgen.generate(shape, 3000, distribution=dist, seed=2**31 + 8, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    coords, values = a
    assert coords.dtype == torch.int32 and values.dtype == torch.float32
    assert coords.shape == (3000, len(shape)) and values.shape == (3000,)
    assert (coords >= 0).all() and (coords < torch.tensor(shape)).all()
    rows = coords.numpy()
    uniq = np.unique(rows, axis=0)
    assert len(uniq) == 3000 and np.array_equal(uniq, rows)  # distinct, lexicographic


def test_generate_caps_at_the_cell_count():
    coords, _ = tensorgen.generate((3, 4, 5), 1000, distribution="uniform", seed=1,
                                   device="cpu")
    assert coords.shape[0] == 60


def test_generate_negative_and_huge_seeds():
    for seed in (-5, 2**40 + 3):
        coords, _ = tensorgen.generate((10, 10, 10), 50, distribution="uniform", seed=seed,
                                       device="cpu")
        assert coords.shape == (50, 3)


def _hot_share(coords: np.ndarray, mode: int) -> float:
    return np.bincount(coords[:, mode]).max() / coords.shape[0]


@pytest.mark.parametrize("dist", ["uniform", "powerlaw"])
def test_distribution_matches_the_ports_generator(dist):
    """The hottest row's share of each mode, averaged over seeds, matches
    `random_tensor`'s (numpy draws from the same law)."""
    from repro_torch.core.sptensor import random_tensor
    shape, nnz = (50, 80, 40, 3000), 6000
    ours, theirs = [], []
    for seed in range(8):
        c, _ = tensorgen.generate(shape, nnz, distribution=dist, seed=seed, device="cpu")
        st = random_tensor(shape, nnz, distribution=dist, seed=seed)
        ours.append([_hot_share(c.numpy(), m) for m in range(4)])
        theirs.append([_hot_share(st.coords, m) for m in range(4)])
    np.testing.assert_allclose(np.mean(ours, 0), np.mean(theirs, 0), rtol=0.25)


@pytest.mark.parametrize(("config", "shape", "nnz", "dist"), [
    ("frostt-nell2", [12092, 9184, 28818], 76_879_419, "uniform"),
    ("frostt-lbnl", [1605, 4198, 1631, 4209, 868131], 1_698_825, "powerlaw"),
])
def test_configs_hold_the_published_sizes(config, shape, nnz, dist):
    cfg = json.loads((manifest.HERE / "configs" / f"{config}.json").read_text())
    assert (cfg["shape"], cfg["nnz"], cfg["distribution"], cfg["rank"]) == (shape, nnz, dist, 10)
    assert cfg["reduced"] == []
