import pytest

from perfbench import roofline


def test_bytes_and_flops_by_hand():
    # 5 nonzeros of a (2, 3, 4) tensor, rank 2: the tensor 5 * (3 * 4 + 4) = 80 B;
    # mode 0 reads factors 1 and 2, (3 + 4) * 2 * 4 = 56 B, writes (2, 2): 16 B.
    assert roofline.mttkrp_bytes((2, 3, 4), 5, 2, 0) == 152
    assert roofline.mttkrp_bytes((2, 3, 4), 5, 2, 2) == 80 + (2 + 3) * 8 + 4 * 8
    assert roofline.mttkrp_flops((2, 3, 4), 5, 2) == 30


def test_nell2_iteration_bound():
    shape, nnz = (12092, 9184, 28818), 76_879_419
    assert roofline.mttkrp_bytes(shape, nnz, 10, 0) == 1_232_074_464
    assert roofline.iteration_bound_s(shape, nnz, 10, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(1.1034e-3, rel=1e-4)


def test_bound_takes_the_larger_and_knows_its_card():
    name = "NVIDIA H100 80GB HBM3"
    assert roofline.bound_s(3.35e12, 1.0, name) == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12, name) == pytest.approx(1.0)
    with pytest.raises(KeyError):
        roofline.bound_s(1.0, 1.0, "cpu")
