"""The port's SSM and hybrid families against the JAX package's on the
CPU: xlstm-350m (mLSTM and sLSTM blocks, no MLP) and jamba-1.5-large-398b
(Mamba, attention, dense and MoE MLPs; bfloat16 params at full width), at
their smoke configs.  The cases and their tolerances are
tests/_lm_families.py's; this file runs them for these two archs, with
the cases that are not per arch split between it and
tests/test_torch_lm_moe.py."""
import pytest
from _lm_families import (  # noqa: F401 -- collected here
    test_caches_hold_float32_states_on_the_device,
    test_full_width_init_matches_reference,
    test_generate_matches_reference,
    test_init_casts_each_leaf_as_it_is_drawn,
    test_init_matches_reference_shapes,
    test_lm_builds_full_and_smoke,
    test_model_matches_reference,
    test_serve_lm_example_matches_reference,
    test_train_step_matches_reference,
)


@pytest.fixture(params=["xlstm_350m", "jamba_1_5_large_398b"])
def arch(request):
    return request.param
